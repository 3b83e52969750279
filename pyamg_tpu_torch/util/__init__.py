"""Host utilities of the port's SA setup (copies from ``pyamg_tpu/util``)."""
