"""Host-side helpers shared by the port's serving layers (copies of the
parts of ``mlrun_tpu/common`` they use)."""
