"""Reading user-supplied ``.pth`` state dicts (counterpart of
``pcgan_tpu/utils/pth_import.py:228-250``).

``torch.load(weights_only=True)`` by default: an external file's pickled
code never runs. A full-module save needs ``allow_pickle=True``
(``--allow_pickle``), which warns that it executes the file's code.
"""

from __future__ import annotations

import warnings

import torch


def load_pth(path: str, allow_pickle: bool = False) -> dict:
    """The state dict in ``path`` (a module's ``state_dict()`` when the file
    holds a module). Raises ValueError for a file ``weights_only`` refuses
    unless ``allow_pickle``; a missing file raises FileNotFoundError."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except FileNotFoundError:
        raise
    except Exception as e:
        if not allow_pickle:
            raise ValueError(
                f"{path} is not a plain state_dict loadable with "
                f"weights_only=True ({type(e).__name__}). If this is a "
                f"full-module save from a source you trust, re-run with "
                f"--allow_pickle (WARNING: that executes arbitrary pickled "
                f"code from the file).") from e
        warnings.warn(f"loading {path} with weights_only=False: this "
                      f"executes arbitrary pickled code from the file",
                      stacklevel=2)
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return obj
