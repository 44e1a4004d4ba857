"""Multi-process data parallelism over torch.distributed (mesh.py): one
process per device, launched by torchrun or any launcher that sets its
environment."""
