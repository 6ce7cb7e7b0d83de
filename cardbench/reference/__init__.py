"""The plain reference: the cells' FedGKD rounds in fp32 with TF32 off,
in plain PyTorch, and the comparison that decides ``correct``.  Imports
nothing of ``repro_torch``; works out again everything the port derives
from the inputs the harness hands both sides."""
