"""The plain reference that decides ``correct``: the CAE (``cae.py``), the
reader of cae_tpu frames (``rans.py`` with the tables' arithmetic in
``xla_f32.py`` and ``cdf.py``) and the checkpoint reader
(``checkpoint.py``).  Plain PyTorch and numpy; it imports nothing of the
program, nothing of JAX, and takes no weights, tables or symbols that the
program made.  Frozen: a later change of the program is judged by it.
"""
