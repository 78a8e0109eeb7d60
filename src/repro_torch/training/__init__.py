"""Training of the port: the Markov data pipeline (:mod:`.data`), AdamW
over trees of tensors (:mod:`.optim`) and the train step and preemption-
safe loop (:mod:`.train`), modelled on ``repro.training``."""
