"""Device-memory plan of a training config (counterpart of
``tools/memory_plan.py``).

    python -m pcgan_tpu_torch.tools.memory_plan --size 256 --batch 64
    python -m pcgan_tpu_torch.tools.memory_plan --size 512 --batch 8 --sweep

The JAX tool reads XLA's buffer assignment from an ahead-of-time compile.
PyTorch has no such plan, so these numbers are MEASURED, not planned
ahead: each variant builds the train state on the card and runs one real
step (B1 + the fused step of ``bench.train_step_fn``) after
``torch.cuda.reset_peak_memory_stats``. Its ``peak_gib`` is
``torch.cuda.max_memory_allocated``; ``state_gib`` the bytes of the
resident state (G's and D's parameters and norm state, both Adam moments
and counts, the pool, the EMA twin); ``batch_gib`` the u8 batch and its
bins; ``temp_gib`` the peak less the state and the batch (activations,
gradients, workspaces). A variant whose step raises
``torch.cuda.OutOfMemoryError`` "does not fit". ``--sweep`` compares the
memory levers: base, ``--remat``, ``--grad_accum`` 2 and 4, and remat with
accumulation 2. On the CPU there is no peak (``null``): only the state
bytes are given.
"""

from __future__ import annotations

import argparse
import gc
import json

import torch

from pcgan_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                    RunConfig, TrainConfig)

GIB = 1024 ** 3
SWEEP = [(False, 1), (True, 1), (False, 2), (False, 4), (True, 2)]


def build_cfg(args, remat: bool, accum: int) -> Config:
    run = RunConfig(device=args.device)
    if args.smoke:
        b = args.batch or 8
        return Config(
            data=DataConfig(batch_size=b, crop_size=32, load_size=36,
                            n_age_bins=4),
            model=ModelConfig(netG="resnet_6blocks", ngf=8, ndf=8,
                              dtype="float32", remat=remat),
            train=TrainConfig(pool_size=b, grad_accum=accum), run=run)
    b = args.batch or {128: 64, 256: 64, 512: 8}.get(args.size, 32)
    return Config(
        data=DataConfig(batch_size=b, crop_size=args.size,
                        load_size=int(args.size * 143 / 128), n_age_bins=10),
        model=ModelConfig(netG=args.netG, dtype=args.dtype, remat=remat),
        train=TrainConfig(pool_size=((50 + b - 1) // b) * b,
                          grad_accum=accum, ema_decay=args.ema_decay),
        run=run)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def state_bytes(state) -> dict:
    """Bytes of the train state by part. ``params``: G's and D's
    parameters; ``adam_moments``: both optimizers' first and second
    moments; ``adam_counts``: their step counts; ``norm_state``: G's and
    D's buffers (running stats, spectral norm); ``pool``; ``ema``."""
    nets = (state.G, state.D)
    opt_states = [s for opt in (state.opt_g, state.opt_d)
                  for s in opt.state.values()]
    return {
        "params": _nbytes(p for n in nets for p in n.parameters()),
        "adam_moments": _nbytes(s[k] for s in opt_states
                                for k in ("exp_avg", "exp_avg_sq")),
        "adam_counts": _nbytes(s["step"] for s in opt_states
                               if isinstance(s.get("step"), torch.Tensor)),
        "norm_state": _nbytes(b for n in nets for b in n.buffers()),
        "pool": _nbytes((state.pool.imgs, state.pool.conds,
                         state.pool.count)),
        "ema": _nbytes(state.ema.values()) if state.ema else 0,
    }


def analyze(cfg: Config):
    """(row, None) for the config's train state and one step, or (None,
    summary) when it does not fit the card."""
    from pcgan_tpu_torch.bench import _device, raw_batch, train_step_fn
    device = _device(cfg)
    cuda = device.type == "cuda"
    try:
        state, run = train_step_fn(cfg, device)
        raw = raw_batch(cfg, device)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        float(run(raw)["loss_G"])
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        parts = state_bytes(state)
        state_b = sum(parts.values())
        batch_b = _nbytes(raw.values())
        row = {"state_gib": state_b / GIB, "batch_gib": batch_b / GIB,
               "temp_gib": (None if peak is None
                            else (peak - state_b - batch_b) / GIB),
               "peak_gib": None if peak is None else peak / GIB,
               "state_bytes": parts}
        err = None
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e)
        row, err = None, (msg[:160] + "..." if len(msg) > 160 else msg)
    state = run = raw = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return row, err


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--batch", type=int, default=0,
                   help="0 = the resolution's bench default")
    p.add_argument("--netG", type=str, default="resnet_9blocks")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="> 0 adds the EMA twin to the resident state")
    p.add_argument("--sweep", action="store_true",
                   help="compare base / remat / accum 2,4 / remat+accum")
    p.add_argument("--smoke", action="store_true", help="tiny config")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from pcgan_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    limit = (torch.cuda.get_device_properties(device).total_memory
             if device.type == "cuda" else 0)
    rows = []
    for remat, accum in (SWEEP if args.sweep
                         else [(args.remat, args.grad_accum)]):
        cfg = build_cfg(args, remat, accum)
        if cfg.data.batch_size % accum:
            continue
        res, err = analyze(cfg)
        row = {"remat": remat, "grad_accum": accum}
        row.update(res or {"error": err})
        rows.append(row)
        tag = f"remat={int(remat)} accum={accum}:"
        if res is None:
            print(f"{tag:22s} DOES NOT FIT ({err})", flush=True)
        elif res["peak_gib"] is None:
            print(f"{tag:22s} state {res['state_gib']:.3f} GiB (no peak "
                  f"on the CPU)", flush=True)
        else:
            fit = (f"  ({100 * res['peak_gib'] * GIB / limit:.0f}% of "
                   f"{limit / GIB:.1f} GiB)" if limit else "")
            print(f"{tag:22s} peak {res['peak_gib']:6.2f} GiB — state "
                  f"{res['state_gib']:.2f} + temp {res['temp_gib']:.2f}"
                  f"{fit}", flush=True)
    size = 32 if args.smoke else args.size
    out = {"metric": f"memory_plan_{size}px",
           "batch": build_cfg(args, False, 1).data.batch_size,
           "backend": device.type,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "hbm_limit_gib": round(limit / GIB, 2) if limit else None,
           "rows": [{k: (round(v, 3) if isinstance(v, float) else v)
                     for k, v in r.items()} for r in rows]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
