"""Host relaxation of the port's SA setup (copies from
``pyamg_tpu/relaxation``)."""
