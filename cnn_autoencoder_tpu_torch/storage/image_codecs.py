"""JPEG / JPEG2000 chunk codecs through PIL (classical-codec baselines).

The port's own copy of the JAX package's ``storage/image_codecs.py``, with
the same ids and configs; PIL is imported at first use, so the module
imports where PIL is not installed.
"""

import io

import numpy as np

from .codecs import Codec, ndarray_copy, register_codec


class _PILImageCodec(Codec):
    pil_format = None

    def __init__(self, level: int = 90):
        self.level = int(level)

    def _save_kwargs(self):
        return {"quality": self.level}

    def encode(self, buf) -> bytes:
        from PIL import Image
        arr = np.asarray(buf)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        bio = io.BytesIO()
        Image.fromarray(arr).save(bio, format=self.pil_format,
                                  **self._save_kwargs())
        return bio.getvalue()

    def decode(self, buf, out=None):
        from PIL import Image
        with Image.open(io.BytesIO(bytes(buf))) as im:
            arr = np.asarray(im)
        if arr.ndim == 2:
            arr = arr[..., None]
        return ndarray_copy(np.ascontiguousarray(arr), out)

    def get_config(self):
        return {"id": self.codec_id, "level": self.level}


class Jpeg(_PILImageCodec):
    codec_id = "imagecodecs_jpeg"
    pil_format = "JPEG"


class Jpeg2k(_PILImageCodec):
    codec_id = "imagecodecs_jpeg2k"
    pil_format = "JPEG2000"

    def _save_kwargs(self):
        # PIL JPEG2000: quality via quality_layers (PSNR-ish scale)
        return {"quality_mode": "dB",
                "quality_layers": [max(20.0, self.level / 2.0)],
                "irreversible": True}


register_codec(Jpeg)
register_codec(Jpeg2k)
