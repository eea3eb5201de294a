"""Plain float32 PyTorch and NumPy reference of what a cell serves.

Imports nothing of the program: the forward pass (``model``), the
boundary quantizer (``codec``) and a frozen copy of the ``model``-mode
clip calibration (``calibration``) are written out here.
"""
