"""Stochastic weight averaging over generator checkpoints, offline
(counterpart of ``tools/average_ckpts.py``).

    python -m pcgan_tpu_torch.tools.average_ckpts --checkpoints_dir /ckpt \\
        --name run --tags epoch_10,epoch_15,epoch_20 --out swa [--use_ema]
    python -m pcgan_tpu_torch.test ... --name run --epoch swa

Averages G's floating parameters over several saved tags, the SWA recipe
(Izmailov et al. 2018) applied after training: one averaged G without
retraining. Reads G-only tags (``{tag}_G.pt``; with ``--use_ema`` the
``{tag}_G_ema.pt`` twins) or full-state tags (``{tag}.pt``: its G, or its
EMA twin over G's buffers). Buffers (batch norm's running statistics and
``num_batches_tracked``, spectral norm's ``u``/``sigma``) are taken from
the LAST tag: averaging statistics across training stages mixes
estimators of different distributions. Writes ``{out}_G.pt``, which
``test --epoch <out>``, ``tools.export_serving`` and ``--init_g_from``
load unchanged.
"""

from __future__ import annotations

import argparse
import os

import torch

# state_dict leaves that are buffers, not parameters, in the port's nets
BUFFER_LEAVES = ("running_mean", "running_var", "num_batches_tracked", "u",
                 "sigma")


def is_param(key: str, value: torch.Tensor) -> bool:
    return (value.is_floating_point()
            and key.rpartition(".")[2] not in BUFFER_LEAVES)


def load_g(checkpoints_dir: str, name: str, tag: str, use_ema: bool) -> dict:
    """G's state dict (or its EMA twin's) from a G-only or full-state tag."""
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    g_path = ckpt.generator_path(checkpoints_dir, name, tag, use_ema)
    if os.path.isfile(g_path):
        return torch.load(g_path, map_location="cpu", weights_only=True)
    full = ckpt.state_path(checkpoints_dir, name, tag)
    if os.path.isfile(full):
        sd = torch.load(full, map_location="cpu", weights_only=True)
        if not use_ema:
            return sd["G"]
        if sd.get("ema") is None:
            raise SystemExit(f"{full} has no EMA twin (trained without "
                             f"--ema_decay?); drop --use_ema")
        return {**sd["G"], **sd["ema"]}
    raise SystemExit(f"no checkpoint at {g_path} or {full}")


def average(sds) -> dict:
    """The mean of the floating parameters of ``sds`` (accumulated in
    float64), the buffers of the last one."""
    first, last = sds[0], sds[-1]
    out = dict(last)
    for k, v in first.items():
        if is_param(k, v):
            acc = torch.zeros(v.shape, dtype=torch.float64)
            for sd in sds:
                acc += sd[k].double()
            out[k] = (acc / len(sds)).to(v.dtype)
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="average G params across checkpoint tags (offline SWA)")
    ap.add_argument("--checkpoints_dir", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--tags", required=True,
                    help="comma-separated tags to average, e.g. "
                         "'epoch_10,epoch_15,latest' (G-only and full-state "
                         "tags both work)")
    ap.add_argument("--out", default="swa",
                    help="output tag; writes <out>_G (default: swa)")
    ap.add_argument("--use_ema", action="store_true",
                    help="average the _G_ema twins instead of the live G")
    args = ap.parse_args(argv)

    from pcgan_tpu_torch.utils import checkpoint as ckpt
    tags = [t.strip() for t in args.tags.split(",") if t.strip()]
    if len(tags) < 2:
        raise SystemExit("--tags needs at least two tags to average")
    sds = []
    for tag in tags:
        sd = load_g(args.checkpoints_dir, args.name, tag, args.use_ema)
        if sds and (set(sd) != set(sds[0]) or any(
                v.shape != sds[0][k].shape for k, v in sd.items())):
            raise SystemExit(f"tag '{tag}' has a different G structure "
                             f"than '{tags[0]}' — cannot average across "
                             f"architectures")
        sds.append(sd)
        print(f"loaded {tag}", flush=True)
    path = ckpt.save_generator(average(sds), args.checkpoints_dir, args.name,
                               tag=args.out)
    print(f"wrote averaged G ({len(tags)} tags"
          f"{', EMA twins' if args.use_ema else ''}) -> {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
