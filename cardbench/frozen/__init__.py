"""The yardstick, frozen: later changes to the port do not move it.

Peaks and cost functions (``roofline``), the parameter layouts and the
weights drawn from a seed (``layouts``), and the data generators
(``data``).  Plain PyTorch and numpy; nothing of ``repro_torch``."""
