"""Write the weights of ``--fid_features random`` for the port.

    JAX_PLATFORMS=cpu python tests/torch_port_data/make_random_features.py

The JAX package draws its random FID feature net (``pcgan_tpu/ops/fid.py``
``RandomConvFeatures``, 3 input channels) from flax's init under
``jax.random.PRNGKey(42)``. torch cannot reproduce those draws, so the port
reads the same numbers from ``pcgan_tpu_torch/ops/fid_random_features.npz``:
flax's params flattened with '/' (``Conv_0/kernel`` HWIO, ...,
``Dense_0/bias``), 1,010,240 f32 values. The draw does not depend on the
image size (the size only shapes the dummy init input); this script checks
that at 32, 128 and 256 px before it writes. ``fid_random_features.json``
beside this script records the file's sha256.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "pcgan_tpu_torch", "ops", "fid_random_features.npz")
DIGEST = os.path.join(HERE, "fid_random_features.json")
SEED = 42


def jax_params(image_size: int = 32, channels: int = 3) -> dict:
    """flax's init of ``RandomConvFeatures`` as {'/'-path: f32 array}."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict
    from pcgan_tpu.ops.fid import RandomConvFeatures
    v = RandomConvFeatures().init(
        jax.random.PRNGKey(SEED),
        jnp.zeros((1, image_size, image_size, channels)))
    return {k: np.asarray(a, np.float32)
            for k, a in flatten_dict(v["params"], sep="/").items()}


def main() -> None:
    ref = jax_params(32)
    for size in (128, 256):
        other = jax_params(size)
        assert set(other) == set(ref)
        assert all(np.array_equal(other[k], ref[k]) for k in ref), size
    n = sum(a.size for a in ref.values())
    np.savez(OUT, **ref)
    with open(OUT, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    with open(DIGEST, "w") as f:
        json.dump({"file": "pcgan_tpu_torch/ops/fid_random_features.npz",
                   "sha256": digest, "values": int(n), "seed": SEED,
                   "made_by": "tests/torch_port_data/"
                              "make_random_features.py"}, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}: {n} values, sha256 {digest}")


if __name__ == "__main__":
    main()
