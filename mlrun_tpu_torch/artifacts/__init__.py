"""Model artifacts — counterpart of ``mlrun_tpu/artifacts`` (what the port
has of it: ``model.get_model``)."""
