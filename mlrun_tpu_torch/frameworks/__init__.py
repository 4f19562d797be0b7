"""Framework adapters of the port: the torch auto-trainer, the structured
callbacks (``_common``) and the HuggingFace checkpoint loader and
pipeline server (``huggingface``)."""
