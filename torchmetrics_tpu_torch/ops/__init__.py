"""Device operations of the PyTorch port (counterpart of ``torchmetrics_tpu/ops``).

``ops.histogram`` holds the counting entries; ``ops.bincount`` is kernel K1 with its plain
version. The entries are not re-exported here, so that ``ops.bincount`` stays the module.
"""
