"""The benchmark of cnn_autoencoder_tpu_torch (``run.py``)."""
