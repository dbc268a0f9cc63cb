"""Serving export of the port (counterpart of ``pcgan_tpu/serving.py``): a
trained generator or comparator as one self-contained ``torch.export``
program.

- The weights live inside the program (``generator.pt2`` /
  ``comparator.pt2``), so a host loads it with torch + numpy and no model
  code, options parser or checkpoint.
- The batch dimension is exported symbolically (``torch.export.Dim``): one
  artifact serves every batch size. ``--fixed_batch`` pins it instead, and
  the loader pads and slices requests to that size.
- The call contract is fixed at export: f32 NHWC images in [-1, 1] and an
  f32 condition row (one-hot age bins, or a 1-channel normalized score
  under ``cond_mode=score``) -> f32 images. The casts to the compute dtype
  (bf16 on the perf path) happen inside the program.
- Exported on the CPU, the program runs on both devices:
  ``load_exported(dir, device="cuda")`` moves it onto the card
  (``torch.export.passes.move_to_device_pass``). ``meta.json`` has the JAX
  format's keys, with ``"format": "pcgan_tpu_torch.serving/1"``.
- An int8 generator (``--quant_int8``) stores each trunk weight as its int8
  matrix and scales, quantized once at export (``ops.quant.
  freeze_quant_weights``; the same numbers as quantizing on each call),
  and its calibrated activation absmaxes.

``load_exported`` imports only torch and numpy, never the port's models.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Optional, Sequence

import numpy as np

_META = "meta.json"
_FORMAT = "pcgan_tpu_torch.serving/1"
_JAX_FORMAT = "pcgan_tpu.serving/1"
_ARTIFACTS = {"generator": "generator.pt2", "comparator": "comparator.pt2"}
PLATFORMS = ("cuda", "cpu")
_EXAMPLE_BATCH = 2


def check_platforms(platforms: Sequence[str]) -> list:
    """The export's platforms: a non-empty subset of ``cuda``, ``cpu``."""
    platforms = list(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(
            f"platforms {platforms}: a torch.export artifact runs on "
            f"{' | '.join(PLATFORMS)} (the JAX package's 'tpu' lowering has "
            f"no counterpart here)")
    return platforms


def make_infer_fn(cfg, G):
    """The fixed serving contract around ``G`` as a module: (images f32,
    cond f32) -> f32 fakes, with the compute-dtype casts inside."""
    import torch
    from pcgan_tpu_torch.models.registry import compute_dtype

    class ServeG(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.G = G
            # bf16 for a bf16 model, else f32 (an f16 model's layers cast
            # inside), as pcgan_tpu/serving.py
            self.compute_dtype = compute_dtype(cfg.model.dtype)

        def forward(self, images, cond):
            out = self.G(images.to(self.compute_dtype),
                         cond.to(self.compute_dtype))
            return out.float()

    return ServeG()


def _export(module, args, fixed_batch: Optional[int]):
    import torch
    dyn = None
    if fixed_batch is None:
        b = torch.export.Dim("b", min=1)
        dyn = tuple({0: b} for _ in args)
    with torch.no_grad():
        return torch.export.export(module, args, dynamic_shapes=dyn)


def _guard_out_dir(out_dir: str, kind: str):
    """Refuse to repoint an existing export dir at a DIFFERENT artifact
    kind: overwriting meta.json would orphan the other artifact and break
    every host serving the directory."""
    meta_path = os.path.join(out_dir, _META)
    if not os.path.isfile(meta_path):
        return
    try:
        with open(meta_path) as f:
            old = json.load(f)
    except (OSError, json.JSONDecodeError):
        return
    old_kind = old.get("kind", "generator") if isinstance(old, dict) else None
    if old_kind is not None and old_kind != kind:
        raise ValueError(
            f"{out_dir} already holds a {old_kind} export; write the "
            f"{kind} to a separate out_dir")


def _write(ep, out_dir: str, kind: str, meta: dict) -> str:
    """The program, then meta.json last: its mtime marks a complete
    artifact for ``serve_http --watch_seconds``."""
    import torch
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _ARTIFACTS[kind])
    tmp = path[:-len(".pt2")] + ".tmp.pt2"
    torch.export.save(ep, tmp)
    os.replace(tmp, path)
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return path


def _cpu_eval_copy(module):
    return copy.deepcopy(module).cpu().eval()


def export_generator(cfg, G, out_dir: str,
                     platforms: Sequence[str] = PLATFORMS,
                     fixed_batch: Optional[int] = None,
                     ema_source: bool = False) -> str:
    """Export ``G`` (any device; copied to the CPU) to
    ``out_dir/generator.pt2`` + ``meta.json``. ``fixed_batch=None``
    exports a symbolic batch. Returns the artifact path."""
    import torch
    from pcgan_tpu_torch.ops.quant import freeze_quant_weights
    platforms = check_platforms(platforms)
    _guard_out_dir(out_dir, "generator")
    Gc = freeze_quant_weights(_cpu_eval_copy(G))
    s, b = cfg.data.crop_size, fixed_batch or _EXAMPLE_BATCH
    args = (torch.zeros(b, s, s, cfg.data.input_nc),
            torch.zeros(b, cfg.cond_nc))
    ep = _export(make_infer_fn(cfg, Gc), args, fixed_batch)
    meta = {
        "format": _FORMAT,
        "kind": "generator",
        "platforms": platforms,
        "fixed_batch": fixed_batch,
        "crop_size": s,
        "input_nc": cfg.data.input_nc,
        "output_nc": cfg.data.output_nc,
        "cond_nc": cfg.cond_nc,
        "cond_mode": cfg.model.cond_mode,
        "n_age_bins": cfg.data.n_age_bins,
        "max_age": cfg.data.max_age,
        "netG": cfg.model.netG,
        "compute_dtype": cfg.model.dtype,
        "ema_source": bool(ema_source),
    }
    return _write(ep, out_dir, "generator", meta)


def export_comparator(cfg, C, out_dir: str,
                      platforms: Sequence[str] = PLATFORMS,
                      fixed_batch: Optional[int] = None) -> str:
    """Scoring as a service: export the pretrained comparator to
    ``out_dir/comparator.pt2``: f32 [-1, 1] NHWC images -> (mu, log_var)
    f32, in ``cfg.model.dtype`` inside."""
    import torch
    from pcgan_tpu_torch.models.registry import compute_dtype
    platforms = check_platforms(platforms)
    _guard_out_dir(out_dir, "comparator")
    dt = compute_dtype(cfg.model.dtype)

    class ServeC(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.C = _cpu_eval_copy(C)

        def forward(self, images):
            mu, log_var = self.C(images.to(dt))
            return mu.float(), log_var.float()

    s, b = cfg.data.crop_size, fixed_batch or _EXAMPLE_BATCH
    ep = _export(ServeC(), (torch.zeros(b, s, s, cfg.data.input_nc),),
                 fixed_batch)
    meta = {
        "format": _FORMAT,
        "kind": "comparator",
        "platforms": platforms,
        "fixed_batch": fixed_batch,
        "crop_size": s,
        "input_nc": cfg.data.input_nc,
        "compute_dtype": cfg.model.dtype,
    }
    return _write(ep, out_dir, "comparator", meta)


class _Program:
    """A loaded program on one device: numpy in, numpy out. ``exported``
    is its ``torch.export`` program, which ``on`` places on other
    devices."""

    def __init__(self, module, device, exported=None):
        self.module = module
        self.device = device
        self.exported = exported

    def on(self, device):
        """The program's module on ``device`` (this one's module there)."""
        import torch
        device = torch.device(device)
        if device == self.device:
            return self.module
        from torch.export.passes import move_to_device_pass
        return move_to_device_pass(self.exported, str(device)).module()

    def call(self, *arrays):
        import torch
        with torch.inference_mode():
            out = self.module(*(torch.from_numpy(np.ascontiguousarray(a))
                                .to(self.device) for a in arrays))
            if isinstance(out, (tuple, list)):
                return tuple(o.cpu().numpy() for o in out)
            return out.cpu().numpy()


class ServedComparator:
    """A loaded comparator artifact: ``__call__(images) -> (mu, log_var)``;
    ``score(images) -> mu``. Fixed-batch artifacts pad and slice like the
    generator's."""

    def __init__(self, program: _Program, meta: dict):
        self._program = program
        self.meta = dict(meta)

    def __call__(self, images: np.ndarray):
        images = np.asarray(images, np.float32)
        if images.ndim != 4:
            raise ValueError("expected images (B,H,W,C)")
        b = images.shape[0]
        if b == 0:
            return (np.zeros((0,), np.float32), np.zeros((0,), np.float32))
        fb = self.meta.get("fixed_batch")
        if fb is None:
            return self._program.call(images)
        mus, lvs = [], []
        for at in range(0, b, fb):
            chunk = images[at:at + fb]
            k = chunk.shape[0]
            if k < fb:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], fb - k, axis=0)], axis=0)
            mu, lv = self._program.call(chunk)
            mus.append(mu[:k])
            lvs.append(lv[:k])
        return np.concatenate(mus), np.concatenate(lvs)

    def score(self, images: np.ndarray) -> np.ndarray:
        return self(images)[0]


class ServedGenerator:
    """A loaded generator artifact; needs torch + numpy, no model code.

    ``__call__(images, cond)``: f32 [-1,1] NHWC batch + condition rows ->
    f32 fakes. ``progression(images)``: every condition for every input in
    ONE batched call -> (B, n_conditions, H, W, C), the aging grid.
    """

    def __init__(self, program: _Program, meta: dict):
        self._program = program
        self.meta = dict(meta)

    @property
    def device(self):
        return self._program.device

    # -- call ---------------------------------------------------------------
    def _validate(self, images, cond):
        images = np.asarray(images, np.float32)
        cond = np.asarray(cond, np.float32)
        if images.ndim != 4 or cond.ndim != 2:
            raise ValueError("expected images (B,H,W,C) and cond (B,K)")
        if images.shape[0] != cond.shape[0]:
            raise ValueError(
                f"batch mismatch: images {images.shape[0]} vs cond "
                f"{cond.shape[0]}")
        m = self.meta
        s, in_nc = int(m["crop_size"]), int(m["input_nc"])
        if (images.shape[1:] != (s, s, in_nc)
                or cond.shape[1] != int(m["cond_nc"])):
            # the program's own guard would raise a RuntimeError; a wrong
            # shape is the caller's error (HTTP 400, as the JAX host's)
            raise ValueError(
                f"expected images (B,{s},{s},{in_nc}) and cond "
                f"(B,{m['cond_nc']}); got {images.shape} and {cond.shape}")
        return images, cond

    def _empty(self, images):
        return np.zeros((0, *images.shape[1:-1],
                         int(self.meta["output_nc"])), np.float32)

    def __call__(self, images: np.ndarray, cond: np.ndarray) -> np.ndarray:
        images, cond = self._validate(images, cond)
        if images.shape[0] == 0:
            return self._empty(images)
        fb = self.meta.get("fixed_batch")
        if fb is None:
            return self._program.call(images, cond)
        # fixed-batch artifact: serve any request size by pad + slice
        n = images.shape[0]
        out = []
        for at in range(0, n, fb):
            img_c = images[at:at + fb]
            cnd_c = cond[at:at + fb]
            k = img_c.shape[0]
            if k < fb:
                img_c = np.concatenate(
                    [img_c, np.repeat(img_c[-1:], fb - k, axis=0)], axis=0)
                cnd_c = np.concatenate(
                    [cnd_c, np.repeat(cnd_c[-1:], fb - k, axis=0)], axis=0)
            out.append(self._program.call(img_c, cnd_c)[:k])
        return np.concatenate(out, axis=0)

    # -- conditions ---------------------------------------------------------
    def all_conditions(self) -> np.ndarray:
        """(n_conditions, cond_nc): every age bin one-hot, or the even sweep
        of the normalized score range for score-mode artifacts."""
        nb = int(self.meta["n_age_bins"])
        if self.meta["cond_mode"] == "score":
            return np.linspace(-1.0, 1.0, nb, dtype=np.float32)[:, None]
        return np.eye(nb, dtype=np.float32)

    def sweep_conditions(self, n_frames: int) -> np.ndarray:
        """(n_frames, cond_nc) SMOOTH condition sweep for animations: score
        mode sweeps [-1, 1]; onehot mode blends adjacent bins' one-hots
        (rows sum to 1; a frame on a bin IS that bin's one-hot), in numpy
        as the JAX artifact's host does."""
        if n_frames < 2:
            raise ValueError(f"n_frames must be >= 2, got {n_frames}")
        nb = int(self.meta["n_age_bins"])
        if self.meta["cond_mode"] == "score":
            return np.linspace(-1.0, 1.0, n_frames,
                               dtype=np.float32)[:, None]
        p = np.linspace(0.0, float(nb - 1), n_frames)
        lo = np.clip(np.floor(p).astype(np.int32), 0, nb - 1)
        hi = np.clip(lo + 1, 0, nb - 1)
        frac = (p - lo).astype(np.float32)[:, None]
        eye = np.eye(nb, dtype=np.float32)
        return (1.0 - frac) * eye[lo] + frac * eye[hi]

    def progression(self, images: np.ndarray, call=None) -> np.ndarray:
        """Aging grid (B, n_conditions, H, W, C). ``call`` overrides the
        generator invocation (a serving host's coalescing dispatch), so
        the repeat/tile pairing has one source of truth."""
        return self._sweep(images, self.all_conditions(), call)

    def animation(self, images: np.ndarray, n_frames: int = 24,
                  call=None) -> np.ndarray:
        """Smooth aging sweep (B, n_frames, H, W, C), the serving twin of
        ``test.py --anim`` (frames on a bin match the progression grid)."""
        return self._sweep(images, self.sweep_conditions(n_frames), call)

    def _sweep(self, images: np.ndarray, conds: np.ndarray,
               call=None) -> np.ndarray:
        call = self if call is None else call
        images = np.asarray(images, np.float32)
        if images.ndim != 4:
            raise ValueError("expected images (B,H,W,C)")
        nb = conds.shape[0]
        b = images.shape[0]
        x = np.repeat(images, nb, axis=0)
        c = np.tile(conds, (b, 1))
        fakes = call(x, c)
        return fakes.reshape(b, nb, *fakes.shape[1:])

    def data_parallel(self, devices=None):
        """Serving over several cards from one artifact (the counterpart of
        ``pcgan_tpu/serving.py:331-365``): returns a callable ``(images,
        cond) -> fakes`` that puts the program on each of ``devices``
        (default: every visible card), splits the batch evenly over them,
        runs each shard on its device (launched one after the other, so
        the cards compute at once) and gathers the results in order. A
        ragged batch pads with its last row to a multiple of the device
        count (the result sliced back); an empty one returns an empty
        result. Requires a symbolic-batch artifact (a shard's size
        varies)."""
        import torch
        if self.meta.get("fixed_batch") is not None:
            raise ValueError(
                "data_parallel needs a symbolic-batch artifact (export "
                "without --fixed_batch)")
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("data_parallel: no CUDA device is "
                                   "available (pass devices=[...])")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        mods = {}
        for d in devices:
            if str(d) not in mods:
                mods[str(d)] = self._program.on(d)
        n = len(devices)

        def call(images, cond):
            images, cond = self._validate(images, cond)
            b = images.shape[0]
            if b == 0:
                return self._empty(images)
            pad = (-b) % n
            if pad:
                images = np.concatenate(
                    [images, np.repeat(images[-1:], pad, axis=0)], axis=0)
                cond = np.concatenate(
                    [cond, np.repeat(cond[-1:], pad, axis=0)], axis=0)
            k = images.shape[0] // n
            with torch.inference_mode():
                outs = [mods[str(d)](
                    torch.from_numpy(images[i * k:(i + 1) * k]).to(d),
                    torch.from_numpy(cond[i * k:(i + 1) * k]).to(d))
                    for i, d in enumerate(devices)]
                return np.concatenate([o.cpu().numpy() for o in outs])[:b]

        return call


def load_exported(out_dir: str, device: str = "cuda"):
    """Load an export directory onto ``device`` (``cuda`` unless ``cpu``
    is asked for) -> ServedGenerator or ServedComparator, by the meta's
    ``kind``. Raises on a missing or foreign directory (a JAX export
    included), on a device the artifact was not exported for, and on
    ``cuda`` without a card."""
    import torch
    meta_path = os.path.join(out_dir, _META)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"{out_dir} is not a pcgan_tpu_torch serving export (need "
            f"{_META} + a .pt2 program; produce one with python -m "
            f"pcgan_tpu_torch.tools.export_serving)")
    with open(meta_path) as f:
        meta = json.load(f)
    fmt = meta.get("format") if isinstance(meta, dict) else None
    if fmt == _JAX_FORMAT:
        raise ValueError(
            f"{meta_path}: this is a JAX (pcgan_tpu) StableHLO export; the "
            f"port serves {_FORMAT!r} artifacts: re-export the checkpoint "
            f"with python -m pcgan_tpu_torch.tools.export_serving")
    if fmt != _FORMAT:
        raise ValueError(f"{meta_path}: unsupported format {fmt!r} "
                         f"(expected {_FORMAT!r})")
    kind = meta.get("kind", "generator")
    if kind not in _ARTIFACTS:
        raise ValueError(f"{meta_path}: unknown artifact kind {kind!r}")
    art_path = os.path.join(out_dir, _ARTIFACTS[kind])
    if not os.path.isfile(art_path):
        raise FileNotFoundError(
            f"{out_dir}: meta names a {kind} artifact but "
            f"{_ARTIFACTS[kind]} is missing")
    if device not in PLATFORMS:
        raise ValueError(f"device {device!r}: want cuda or cpu")
    if device not in meta.get("platforms", PLATFORMS):
        raise ValueError(f"{out_dir} was exported for {meta['platforms']}, "
                         f"not {device}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "load_exported(device='cuda'): no CUDA device is available "
            "(pass device='cpu' to serve on the CPU)")
    ep = torch.export.load(art_path)
    if device == "cuda":
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, "cuda")
    program = _Program(ep.module(), torch.device(device), ep)
    cls = ServedComparator if kind == "comparator" else ServedGenerator
    return cls(program, meta)
