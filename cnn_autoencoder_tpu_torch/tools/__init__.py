"""The offline tools: the port of the JAX package's ``scripts/`` tools.

Each runs as ``python -m cnn_autoencoder_tpu_torch.tools.<name>`` with the
flags of ``scripts/<name>.py`` and writes the same outputs:

* ``refit_quantiles``: solve a checkpoint's entropy quantiles by
  bisection, in place;
* ``transfer_weights``: rename keys between compressai-style and CAE-style
  torch checkpoints (``cai2cae``, ``cae2cai``, ``cae2cae``,
  ``last2best``) and convert a reference ``.pth`` into the native msgpack
  (``torch2jax``);
* ``visualize_groups``: latent mosaics, PCA / t-SNE / Isomap embeddings
  (``utils/manifold.py``) and the selection of embedded points;
* ``compute_metrics``, ``dump_metrics_jpeg``, ``dump_training_stats``,
  ``compare_compressors``: classical-codec metrics, their CSV dumps,
  training histories, chunk compressors;
* ``compute_mask``, ``compute_labels``, ``zarr2dataset``, ``zarr2png``,
  ``convert_dataset``: tissue masks, labels and dataset files.

Dense arithmetic (the embeddings, the image metrics, the aux loss) runs in
torch on ``device`` (``None``: the card, which raises without one); exact
host arithmetic (masks, key renaming, CSVs, codecs) stays numpy and scipy,
so the files equal the JAX tools' byte for byte.  No module imports JAX,
flax, msgpack or the JAX package; PIL and matplotlib are imported at first
use, so every module imports on a machine without them.
"""
