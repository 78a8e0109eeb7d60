"""Plain PyTorch references of the cells' models, in float32 with TF32
off.  They import neither JAX nor the JAX package nor anything of the
port, and take nothing the port made."""
