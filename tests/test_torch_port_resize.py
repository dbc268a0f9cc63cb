"""``pil_resize_np`` (Pillow's 8-bit resize in numpy, no Pillow) against
``PIL.Image.resize`` and the JAX package's ``pil_resize_np`` (which calls
Pillow): bit-identical for bicubic, bilinear and nearest, up and down,
square and non-square, on random and on hard-edged images."""

import torch_port_threads  # noqa: F401  (torch's pool: a share of the cores)
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from pcgan_tpu.data.loader import pil_resize_np as j_pil_resize_np
from pcgan_tpu_torch.data.loader import pil_resize_np
from pcgan_tpu_torch.data.resample import resample

FILTERS = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR,
           "nearest": Image.NEAREST}


def _image(seed, h, w, edges):
    rng = np.random.default_rng(seed)
    if edges:     # 0/255 blocks: the filters' negative lobes clip
        return np.where(rng.random((h, w, 1)) < 0.5, 0, 255).astype(
            np.uint8).repeat(3, 2)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@settings(max_examples=60, deadline=None, database=None)
@given(h=st.integers(8, 300), w=st.integers(8, 300),
       out_h=st.integers(8, 300), out_w=st.integers(8, 300),
       method=st.sampled_from(sorted(FILTERS)), seed=st.integers(0, 2**16),
       edges=st.booleans())
def test_resample_equals_pil(h, w, out_h, out_w, method, seed, edges):
    img = _image(seed, h, w, edges)
    want = np.asarray(Image.fromarray(img).resize((out_w, out_h),
                                                  FILTERS[method]))
    got = resample(img, out_h, out_w, method)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", sorted(FILTERS))
@pytest.mark.parametrize("hw,size", [((200, 200), 143), ((250, 250), 286),
                                     ((143, 143), 128), ((180, 220), 200),
                                     ((200, 200), 200), ((37, 300), 64)])
def test_square_resize_equals_the_jax_package(method, hw, size):
    img = _image(sum(hw) + size, *hw, edges=False)
    got = pil_resize_np(img, size, method)
    want = j_pil_resize_np(img, size, method)
    assert got.shape == want.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    if hw == (size, size):
        assert got is img          # no-op when both sides already match


def test_bad_method_and_input_raise():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="lanczos"):
        resample(img, 4, 4, "lanczos")
    with pytest.raises(ValueError, match="u8"):
        resample(img.astype(np.float32), 4, 4)
