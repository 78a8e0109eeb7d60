"""Launchers of the port: ``serve`` replays a serverless invocation trace
through the single-node platform (``python -m repro_torch.launch.serve``)."""
