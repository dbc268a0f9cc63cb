"""A cohort of gloo ranks for the data-parallel tests
(``test_torch_port_parallel_*.py``); a helper, not a test file.

``run_cohort(cases, workdir)`` writes the cases to one file, starts one
process per rank (``python torch_port_parallel_worker.py <file> <rank>
<world> <port> <device>``), waits for all of them under one timeout, killing the
whole cohort when it expires (``tests/test_multihost.py:_drain``), and
returns each rank's results. A rank joins the group through
``parallel.mesh.init_distributed`` (gloo; with ``device='cuda'`` every
rank computes on cuda:0, the ranks sharing the one card) and runs every
case in order; a case is a dict with ``kind`` (a function of this module)
and its inputs. The workers import torch and the port only, never jax.
"""

import contextlib
import os
import socket
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_cohort(cases: dict, workdir: str, world: int = 2,
                 device: str = "cpu", tag: str = "") -> tuple:
    """Starts the ranks of a cohort and returns its handle for
    ``finish_cohort`` (so a test can work while the ranks run)."""
    path = os.path.join(str(workdir), f"cohort_cases{tag}.pt")
    torch.save(cases, path)
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]), "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), path, str(r), str(world),
         port, device], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    return procs, path


def finish_cohort(handle: tuple, timeout: float = 120.0) -> list:
    """Waits for a started cohort (killing every rank once ``timeout``
    expires) and returns each rank's results."""
    procs, path = handle
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} failed:\n{out[-6000:]}"
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [torch.load(f"{path}.rank{r}", weights_only=False)
            for r in range(len(procs))]


def run_cohort(cases: dict, workdir: str, world: int = 2,
               timeout: float = 120.0, device: str = "cpu") -> list:
    """{name: case} -> [{name: result} for each rank]."""
    return finish_cohort(start_cohort(cases, workdir, world, device),
                         timeout)


# --------------------------------------------------------------------------- #
# the cases, run on every rank
# --------------------------------------------------------------------------- #


def _step_result(state, metrics):
    from pcgan_tpu_torch.utils.checkpoint import adam_state
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "G": {k: v.cpu().clone() for k, v in
                  state.G.state_dict().items()},
            "D": {k: v.cpu().clone() for k, v in
                  state.D.state_dict().items()},
            "opt_g": adam_state(state.opt_g, state.G),
            "opt_d": adam_state(state.opt_d, state.D)}


def gan_steps(mesh, case):
    """One data-parallel GAN step from each given state (a
    ``convert_train_state`` payload) on its global batch's local rows."""
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.parallel.train_parallel import (
        make_parallel_train_step, shard_train_state)
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.utils.checkpoint import load_state
    tc, out = case["cfg"], []
    for payload, batch in zip(case["payloads"], case["batches"]):
        G, D = define_G(tc).to(mesh.device), define_D(tc).to(mesh.device)
        state = shard_train_state(create_train_state(
            tc, G, D, torch.Generator().manual_seed(0)), mesh)
        load_state(state, payload)
        step = make_parallel_train_step(tc, G, D, mesh=mesh,
                                        with_preprocess=False)
        margins = []
        local = {k: v.to(mesh.device) for k, v in
                 mesh.local_rows(batch).items()}
        with _relu_margins(margins):
            m = step(state, local)
        out.append({**_step_result(state, m),
                    "relu_margin": min(margins, default=float("inf"))})
    return out


@contextlib.contextmanager
def _relu_margins(seen: list):
    """Records the smallest nonzero |input| of every ``F.relu`` and
    ``F.leaky_relu`` call (G's and D's kinks) while it is open. An exact
    zero is structural (a one-hot's, a dropped unit's), the same in every
    framework, and no f32 noise picks its slope. The frozen VGG trunk's
    ReLUs (``--lambda_vgg``) are not G's or D's kinks and are left out: at
    32 px some of their ~10^5 inputs always lie within 1e-6 of zero."""
    import torch.nn.functional as F
    from pcgan_tpu_torch.models import vgg
    fns = {"relu": F.relu, "leaky_relu": F.leaky_relu}
    in_vgg, forward = [0], vgg._VGGTaps.forward

    def watch(fn):
        def wrapped(x, *args, **kwargs):
            a = x.detach().abs()
            a = a[a > 0]
            if a.numel() and not in_vgg[0]:        # a band may be empty
                seen.append(float(a.min()))
            return fn(x, *args, **kwargs)
        return wrapped

    def vgg_forward(self, x):
        in_vgg[0] += 1
        try:
            return forward(self, x)
        finally:
            in_vgg[0] -= 1
    for name, fn in fns.items():
        setattr(F, name, watch(fn))
    vgg._VGGTaps.forward = vgg_forward
    try:
        yield
    finally:
        for name, fn in fns.items():
            setattr(F, name, fn)
        vgg._VGGTaps.forward = forward


def comparator_steps(mesh, case):
    """One data-parallel comparator step from each given state."""
    from pcgan_tpu_torch.models import define_C
    from pcgan_tpu_torch.parallel.train_parallel import (
        make_parallel_comparator_step)
    from pcgan_tpu_torch.train import create_comparator_state
    from pcgan_tpu_torch.utils.checkpoint import adam_state, \
        load_comparator_state
    tc, out = case["cfg"], []
    for payload, batch in zip(case["payloads"], case["batches"]):
        C = define_C(tc)
        state = create_comparator_state(tc, C,
                                        torch.Generator().manual_seed(0))
        load_comparator_state(state, payload)
        step = make_parallel_comparator_step(tc, C, mesh=mesh,
                                             with_preprocess=False)
        m = step(state, mesh.local_rows(batch))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "C": {k: v.clone() for k, v in C.state_dict().items()},
                    "opt": adam_state(state.opt, C)})
    return out


def cache_batches(mesh, case):
    """An epoch and the eval pass of the sharded device cache: this rank's
    rows of every batch."""
    from pcgan_tpu_torch.data import loader as data_loader
    from pcgan_tpu_torch.data.device_cache import DeviceCacheLoader
    cfg = case["cfg"]
    ds = data_loader.create_dataset(cfg, train=True)
    ld = DeviceCacheLoader(cfg, ds, mesh.device, shuffle=True, seed=3,
                           mesh=mesh, sharded=True)
    epoch = [{k: v.clone() for k, v in b.items()} for b in ld]
    return {"n_loc": ld.n_loc, "epoch": epoch,
            "eval": [{k: v.clone() for k, v in b.items()}
                     for b in ld.eval_iter()]}


def fid_eval(mesh, case):
    """The streaming evaluator over this rank's rows of each global
    batch."""
    from pcgan_tpu_torch.eval_lib import make_fid_evaluator
    from pcgan_tpu_torch.models import define_G
    cfg = case["cfg"]
    G = define_G(cfg)
    G.load_state_dict(case["G"])
    run = make_fid_evaluator(cfg, None, mesh.device, mesh)
    return run(G, iter([mesh.local_rows(b) for b in case["batches"]]),
               max_images=case["max_images"], seed=case["seed"])


def mesh_shape_raises(mesh, case):
    """``check_mesh_shape`` on this world: the error of each shape."""
    from pcgan_tpu_torch.parallel.mesh import check_mesh_shape
    out = {}
    for shape in case["shapes"]:
        try:
            check_mesh_shape(shape, mesh.world)
            out[shape] = None
        except ValueError as e:
            out[shape] = str(e)
    return out


class _Cut(Exception):
    pass


def train_runs(mesh, case):
    """``train_main.main`` on every rank in this cohort's group, once per
    (argv, cut) of ``case['runs']``: a run with ``cut`` stops right after
    its checkpoint at that step (every rank at once). Returns each run's
    final step, or 'cut'."""
    from pcgan_tpu_torch import train_main
    from pcgan_tpu_torch.utils import checkpoint as ckpt
    os.environ.update(WORLD_SIZE=str(mesh.world), RANK=str(mesh.rank),
                      LOCAL_RANK="0")
    save, out = ckpt.save_state, []
    for argv, cut in case["runs"]:
        def cutting(state, *args, **kwargs):
            path = save(state, *args, **kwargs)
            if state.step == cut:
                raise _Cut
            return path
        ckpt.save_state = cutting
        try:
            out.append(train_main.main(argv)["step"])
        except _Cut:
            out.append("cut")
        finally:
            ckpt.save_state = save
    return out


def _case_mesh(mesh, case):
    """The case's mesh (``shape``, ``axes``, optional ``dcn_data`` and
    ``granules``: each rank's granule id) over this cohort's world."""
    from pcgan_tpu_torch.parallel.mesh import DataMesh, make_mesh
    granules = case.get("granules")
    return make_mesh(DataMesh(mesh.world, mesh.rank, mesh.device,
                              mesh.group),
                     case["shape"], case["axes"], case.get("dcn_data", 1),
                     None if granules is None else granules.__getitem__)


@contextlib.contextmanager
def _replay_keeps(keeps):
    """Inside, the generators' dropout draws are ``keeps`` ({block or
    level: the global batch's NCHW mask}), of which each rank's G keeps
    its rows (and, on a spatial line, its band); None: their own draws."""
    from pcgan_tpu_torch.models.generator import (ResnetGenerator,
                                                  UnetGenerator)
    own = ResnetGenerator.draw_keeps, UnetGenerator.draw_keeps

    def take(m, rows, device):
        return (m if rows is None else rows.take(m)).to(device)
    if keeps is not None:
        ResnetGenerator.draw_keeps = lambda self, h, H, g, rows=None: [
            take(keeps[i], rows, h.device) for i in range(len(self.blocks))]
        UnetGenerator.draw_keeps = lambda self, x, g, rows=None: {
            i: take(m, rows, x.device) for i, m in keeps.items()}
    try:
        yield
    finally:
        ResnetGenerator.draw_keeps, UnetGenerator.draw_keeps = own


@contextlib.contextmanager
def _replay_draws(draws):
    """Inside, the step's augmentation draws and GP's weights are
    ``draws`` (``{'aug': [(global NHWC shape, the op draws)] in the step's
    call order, 'gp_eps': (B, 1, 1, 1) or None}``, made for the global
    batch), of which the sharded step keeps this rank's rows; None: their
    own draws."""
    from pcgan_tpu_torch import train as ttrain
    from pcgan_tpu_torch.ops import diffaug
    own = diffaug.Augment.draw, ttrain.gp_eps
    queue = [] if draws is None else list(draws["aug"])
    if draws is not None:
        def draw(self, generator, x):
            shape, d = queue.pop(0)
            assert tuple(x.shape) == tuple(shape), (tuple(x.shape), shape)
            return [dict(op) for op in d]
        diffaug.Augment.draw = draw
        if draws.get("gp_eps") is not None:
            ttrain.gp_eps = lambda g, b: draws["gp_eps"]
    try:
        yield
        assert not queue, f"{len(queue)} draws left"
    finally:
        diffaug.Augment.draw, ttrain.gp_eps = own


def _vgg(case):
    """The frozen VGG19 trunk of a ``--lambda_vgg`` case (its state dict in
    ``case['vgg']``), else None."""
    if case.get("vgg") is None:
        return None
    from pcgan_tpu_torch.models.vgg import VGG19Taps
    net = VGG19Taps()
    net.load_state_dict(case["vgg"])
    return net


def sharded_steps(mesh, case):
    """One sharded-state step (``parallel/auto.py``) from each given state
    (a ``save_state``/``convert_train_state`` payload) on this rank's rows
    of its global batch: the step's metrics, the state gathered whole, and
    the rank's own shards after the step. ``case['keeps']``: each step's
    dropout masks, replayed (``_replay_keeps``); ``case['draws']``: each
    step's augmentation draws and GP weights, replayed
    (``_replay_draws``)."""
    from pcgan_tpu_torch.models import define_D, define_G
    from pcgan_tpu_torch.parallel import auto
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.utils.checkpoint import load_state
    tc, out = case["cfg"], []
    mesh = _case_mesh(mesh, case)
    rows = auto.batch_rows(tc, mesh)
    keeps = case.get("keeps") or [None] * len(case["payloads"])
    draws = case.get("draws") or [None] * len(case["payloads"])
    for payload, batch, keep, drawn in zip(case["payloads"],
                                           case["batches"], keeps, draws):
        G, D = define_G(tc).to(mesh.device), define_D(tc).to(mesh.device)
        state = create_train_state(tc, G, D,
                                   torch.Generator().manual_seed(0),
                                   vgg=_vgg(case))
        load_state(state, payload)
        auto.shard_state(state, mesh, tc.parallel.zero1)
        step = auto.make_sharded_train_step(
            tc, G, D, mesh=mesh,
            with_preprocess=case.get("preprocess", False))
        local = {k: torch.as_tensor(v).to(mesh.device)
                 for k, v in mesh.local_rows(batch, rows).items()}
        margins = []
        with _relu_margins(margins), _replay_keeps(keep), \
                _replay_draws(drawn):
            m = step(state, local)
        plan = state.shard_plan
        shards = {}
        for net, opt in (("G", state.opt_g), ("D", state.opt_d)):
            for lf in plan.leaves[net]:
                st = opt.state[lf.opt]
                shards[f"{net}.{lf.name}"] = {
                    "param": lf.master.detach().cpu().clone(),
                    "mu": st["exp_avg"].cpu().clone(),
                    "ema": (state.ema[lf.name].cpu().clone()
                            if net == "G" and state.ema is not None
                            else None)}
        with auto.gathered(state, optimizer=True):
            res = _step_result(state, m)
            res["ema"] = (None if state.ema is None else
                          {k: v.cpu().clone() for k, v in state.ema.items()})
        out.append({**res, "shards": shards,
                    "coords": {ax: mesh.coord(ax) for ax in mesh.axes},
                    "relu_margin": min(margins, default=float("inf"))})
    return out


# --------------------------------------------------------------------------- #
# the spatial axis (test_torch_port_spatial_*.py)
# --------------------------------------------------------------------------- #


def build_piece(spec):
    """(module or None, x (N, C, H, W), cond or None, cotangent of the
    output) of one band-layer case, drawn from the case's seed; the same
    on every rank and in the test that holds the bands to the whole
    image. An attention case's gamma is drawn too (never 0, where the block
    is the identity)."""
    from pcgan_tpu_torch.models.generator import SelfAttention
    from pcgan_tpu_torch.models.layers import (GroupNorm, ResizeConv,
                                               TorchConv, TorchConvTranspose)
    g = torch.Generator().manual_seed(spec["seed"])
    n, c, h, w = 2, spec["cin"], spec["H"], spec.get("W", 12)
    dt = getattr(torch, spec.get("dtype", "float32"))
    x = torch.randn((n, c, h, w), generator=g).to(dt)
    cond = mod = None
    kind = spec["kind"]
    if kind == "conv":
        route = spec.get("route", "plain")
        extra = spec.get("cond", 0)
        mod = TorchConv(c + extra, spec["cout"], spec["k"], spec["s"],
                        spec["p"], spec["mode"],
                        fused_reflect=route == "fused")
        if route == "s2d":
            mod.s2d_r = 4          # the tail's route, held here in f32
        if extra:
            cond = torch.randn((n, extra), generator=g)
    elif kind == "deconv":
        mod = TorchConvTranspose(c, spec["cout"], spec["k"], spec["s"],
                                 spec["p"], spec["op"])
    elif kind == "attn":
        mod = SelfAttention(c)
    elif kind == "resize":
        mod = ResizeConv(c, spec["cout"])
    elif kind == "gnorm":
        mod = GroupNorm(c)
    elif kind == "unet_pair":
        mod = _unet_pair(c)
    if mod is not None:
        with torch.no_grad():
            for prm in mod.parameters():
                prm.copy_(torch.randn(prm.shape, generator=g) * 0.3)
    with torch.no_grad():
        shape = run_piece(mod, x, cond, None, spec).shape
    cot = torch.randn(shape, generator=g)
    return mod, x, cond, cot


def _unet_pair(c):
    """Two U-Net levels, the inner one innermost: the outer's down conv
    and norm, the inner's down and up convs, the skip concats."""
    from torch import nn
    from pcgan_tpu_torch.models.generator import UnetSkipBlock
    return nn.ModuleList([
        UnetSkipBlock(6, 6, 8, 8, innermost=True),
        UnetSkipBlock(c, c, 6, 12)])


def run_piece(mod, x, cond, H, spec):
    """One band layer's output of ``x`` (a band of H rows, or the whole
    image outside ``spatial.banded``): the whole tensor for a
    ``gather_band`` case."""
    from pcgan_tpu_torch.models.layers import instance_norm
    from pcgan_tpu_torch.parallel import spatial
    kind, gh = spec["kind"], spec["H"]
    if kind == "conv":
        return mod(x, cond, H=H)
    if kind in ("deconv", "attn", "resize"):
        return mod(x, H=H)
    if kind == "gnorm":
        return mod(x)
    if kind == "gather":
        return spatial.gather_band(x, gh)
    if kind == "pool":
        return spatial.pool2(x, gh, spec["mode"])
    if kind == "unet_pair":
        inner, outer = mod
        h1 = outer.down.out_size(gh)
        h = outer.down_path(x, None, H and gh)
        hi = inner.down_path(h, None, H and h1)
        hi = inner.up_path(h, hi, None, H and inner.down.out_size(h1))
        return outer.up_path(x, hi, None, H and h1)
    return instance_norm(x)


def spatial_pieces(mesh, case):
    """Each band-layer case of ``case['specs']`` on this rank's band over a
    1 x world data x spatial mesh: the output band (a ``gather_band``
    case: the whole tensor, its cotangent this rank's share of the whole
    one), the gradient of the input band and the parameter gradients
    summed over the line (or the error every rank raises)."""
    import torch.distributed as dist
    from pcgan_tpu_torch.parallel import spatial
    from pcgan_tpu_torch.parallel.axis import COLLECTIVES
    mesh = _case_mesh(mesh, {"shape": (1, mesh.world),
                             "axes": ("data", "spatial")})
    line = spatial.spatial_line(mesh)
    out = {}
    for name, spec in case["specs"].items():
        mod, x, cond, cot = build_piece(spec)
        H = x.shape[2]
        b = spatial.band_of(H, line.n, line.coord)
        xb = x[:, :, b.r0:b.r1].clone().requires_grad_(True)
        params = [] if mod is None else list(mod.parameters())
        try:
            with spatial.banded(line, H):
                y = run_piece(mod, xb, cond, H, spec)
                if spec["kind"] == "gather":
                    # distinct shares that sum to the whole cotangent
                    k = line.coord + 1
                    loss = (y.float() * cot * (2.0 * k / (line.n * (
                        line.n + 1)))).sum()
                else:
                    ob = spatial.band_of(cot.shape[2], line.n, line.coord)
                    loss = (y.float() * cot[:, :, ob.r0:ob.r1]).sum()
                grads = torch.autograd.grad(loss, [xb] + params)
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        gw = [gr.clone() for gr in grads[1:]]
        for gr in gw:
            dist.all_reduce(gr, group=line.group)
        out[name] = {"y": y.detach().float(), "gx": grads[0].float(),
                     "gw": gw, "collectives": dict(COLLECTIVES)}
    return out


def second_piece(mod, x, cond, cot, H, spec, line=None):
    """The double backward of a band layer (or, ``line`` None, of the
    whole image): ``gx``, the input gradient of ``sum(y * y * cot)`` taken
    with ``create_graph``, then the gradients of ``sum(gx * v)`` (``v`` of
    x's shape, drawn from the case's seed) with respect to the input and
    the parameters. On a band, ``x`` is the rank's band, each rank takes
    its band of ``cot`` (of a ``gather_band`` case, a distinct share of the
    whole) and of ``v``, and the returned gradients are the band's, the
    parameter gradients this rank's part (the caller sums them)."""
    from pcgan_tpu_torch.parallel import spatial
    g = torch.Generator().manual_seed(spec["seed"] + 7)
    v = torch.randn(x.shape if line is None else
                    (x.shape[:2] + (spec["H"],) + x.shape[3:]), generator=g)
    params = [] if mod is None else list(mod.parameters())
    x = x.detach().requires_grad_(True)
    y = run_piece(mod, x, cond, H, spec).float()
    if line is None:
        c = cot
    elif spec["kind"] == "gather":
        k = line.coord + 1
        c = cot * (2.0 * k / (line.n * (line.n + 1)))
    else:
        ob = spatial.band_of(cot.shape[2], line.n, line.coord)
        c = cot[:, :, ob.r0:ob.r1]
    if line is not None:
        b = spatial.band_of(spec["H"], line.n, line.coord)
        v = v[:, :, b.r0:b.r1]
    (gx,) = torch.autograd.grad((y * y * c).sum(), x, create_graph=True)
    grads = torch.autograd.grad((gx.float() * v).sum(), [x] + params,
                                allow_unused=True)
    return gx.detach(), [torch.zeros_like(t) if gr is None else gr
                         for gr, t in zip(grads, [x] + params)]


def loss_piece(spec):
    """(module, inputs) of one loss-lever case, drawn from its seed alike on
    every rank: ``penalties`` a D (``spec['flags']``) with real, fake,
    conditions and GP's weights; ``augment`` an NHWC batch and the draws of
    ``spec['policy']`` (with ADA's gates) made for the whole batch;
    ``vgg`` a random VGG19 trunk and two batches."""
    from pcgan_tpu_torch import config as tcfg
    from pcgan_tpu_torch.models import define_D
    from pcgan_tpu_torch.models.vgg import random_vgg19
    from pcgan_tpu_torch.ops.diffaug import Augment
    g = torch.Generator().manual_seed(spec["seed"])
    n, h, w = spec.get("B", 2), spec["H"], spec.get("W", spec["H"])
    x = torch.rand((n, h, w, 3), generator=g) * 2 - 1
    y = torch.rand((n, h, w, 3), generator=g) * 2 - 1
    kind = spec["kind"]
    if kind == "penalties":
        cfg = tcfg.parse_config(["--ndf", "8", "--n_age_bins", "4",
                                 "--dtype", "float32", "--crop_size",
                                 str(h)] + spec["flags"])
        D = define_D(cfg, torch.Generator().manual_seed(spec["seed"]))
        cond = torch.eye(4)[torch.randint(0, 4, (n,), generator=g)]
        eps = torch.rand((n, 1, 1, 1), generator=g)
        return D, {"real": x, "fake": y, "cond": cond, "eps": eps}
    if kind == "augment":
        aug = Augment(spec["policy"], ada=True)
        draws = aug.draw(g, x)
        cot = torch.randn((n, h, w, 3), generator=g)
        return aug, {"x": x, "draws": draws, "cot": cot}
    return random_vgg19(spec["seed"]), {"x": x, "y": y}


def run_loss_piece(mod, inp, spec, line=None):
    """One loss-lever case on the whole batch (``line`` None) or on this
    rank's band inside ``spatial.banded``: {name: value} (a loss: the
    line's whole value) and the gradients (of the input, the fake batch's
    for the penalties case, whose R1 and GP detach theirs: the band's; of
    D's parameters, zero where unused: this rank's part)."""
    from pcgan_tpu_torch.ops.gan_loss import (feature_matching_loss,
                                              gradient_penalty, r1_penalty)
    from pcgan_tpu_torch.models.vgg import vgg_perceptual_loss
    from pcgan_tpu_torch.parallel import spatial
    H = spec["H"]

    def band(t):
        if line is None:
            return t.clone()
        b = spatial.band_of(H, line.n, line.coord)
        return t[:, b.r0:b.r1].clone()
    ctx = (contextlib.nullcontext() if line is None
           else spatial.banded(line, H))
    with ctx:
        if spec["kind"] == "penalties":
            D = mod
            real = band(inp["real"]).requires_grad_(True)
            fake = band(inp["fake"]).requires_grad_(True)
            cond, eps = inp["cond"], inp["eps"]
            r1 = r1_penalty(D, real, cond)
            gp = gradient_penalty(D, real, fake, cond, eps)
            _, rf = D(real, cond, return_features=True)
            _, ff = D(fake, cond, return_features=True)
            sizes = (None if line is None else
                     D.feature_sizes(spatial.global_h(real.shape[1])))
            fm = feature_matching_loss(ff, [f.detach() for f in rf]
                                       if not isinstance(rf[0], tuple) else
                                       [[f.detach() for f in r] for r in rf],
                                       sizes)
            losses = {"r1": r1, "gp": gp, "fm": fm}
            wrt = [fake] + list(D.parameters())   # R1 and GP detach x
            total = r1 + 10.0 * gp + fm
        elif spec["kind"] == "augment":
            x = band(inp["x"]).requires_grad_(True)
            out = mod.apply(x, inp["draws"], spec.get("p", 0.5))
            c = band(inp["cot"])
            losses = {"y": out.detach()}
            wrt, total = [x], (out * c).sum()
        else:
            x = band(inp["x"]).requires_grad_(True)
            vl = vgg_perceptual_loss(mod, x, band(inp["y"]))
            losses, wrt, total = {"vgg": vl}, [x], vl
        grads = [torch.zeros_like(t) if gr is None else gr for gr, t in zip(
            torch.autograd.grad(total, wrt, allow_unused=True), wrt)]
        if line is not None:
            losses = {k: (v if k == "y" else spatial.line_total(v))
                      for k, v in losses.items()}
    return ({k: v.detach() for k, v in losses.items()},
            [gr.detach() for gr in grads])


def band_losses(mesh, case):
    """Each case of ``case['specs']`` on this rank's band over a 1 x world
    data x spatial mesh: a ``second`` case (a band layer's double
    backward, ``second_piece``) or a loss-lever case (``run_loss_piece``),
    the parameter gradients summed over the line."""
    import torch.distributed as dist
    from pcgan_tpu_torch.parallel import spatial
    mesh = _case_mesh(mesh, {"shape": (1, mesh.world),
                             "axes": ("data", "spatial")})
    line = spatial.spatial_line(mesh)
    out = {}
    for name, spec in case["specs"].items():
        if spec["kind"] == "second":
            piece = dict(spec["piece"], seed=spec["seed"])
            mod, x, cond, cot = build_piece(piece)
            H = x.shape[2]
            b = spatial.band_of(H, line.n, line.coord)
            with spatial.banded(line, H):
                gx, grads = second_piece(mod, x[:, :, b.r0:b.r1], cond, cot,
                                         H, piece, line)
            n_in = 1
            res = {"gx": gx}
        else:
            mod, inp = loss_piece(spec)
            res, grads = run_loss_piece(mod, inp, spec, line)
            n_in = 1
        gw = [gr.clone() for gr in grads[n_in:]]
        for gr in gw:
            dist.all_reduce(gr, group=line.group)
        out[name] = {**res, "gin": grads[:n_in], "gw": gw}
    return out


def spatial_steps(mesh, case):
    """Consecutive sharded-state steps from one ``save_state`` payload over
    the case's mesh, B1's plain twin writing each rank's band with every
    draw made (crops, flips, target bins, pool slots): each step's metrics
    and the ranks' bits after it; after the last, the state gathered whole
    (the pool's images whole too); each step's ``spatial.SavedAudit``
    (what autograd kept, and any whole square image among it). With
    ``case['C']`` the frozen comparator (its state dict and score anchors)
    joins the step, with ``case['vgg']`` the VGG19 trunk."""
    from pcgan_tpu_torch.models import define_C, define_D, define_G
    from pcgan_tpu_torch.parallel import auto, spatial
    from pcgan_tpu_torch.train import create_train_state
    from pcgan_tpu_torch.utils.checkpoint import load_state
    tc = case["cfg"]
    mesh = _case_mesh(mesh, case)
    G, D = define_G(tc).to(mesh.device), define_D(tc).to(mesh.device)
    C = None
    if case.get("C") is not None:
        C = define_C(tc)
        C.load_state_dict(case["C"])
    state = create_train_state(tc, G, D, torch.Generator().manual_seed(0),
                               C=C, bin_anchors=case.get("anchors"),
                               vgg=_vgg(case))
    load_state(state, case["payload"])
    auto.shard_state(state, mesh, tc.parallel.zero1)
    step = auto.make_sharded_train_step(tc, G, D, state.C, mesh=mesh)
    rows = auto.batch_rows(tc, mesh)
    n = dict(zip(case["axes"], case["shape"])).get("spatial", 1)
    metrics, band_pool, saved = [], [], []
    for batch in case["batches"]:
        local = {k: torch.as_tensor(v).to(mesh.device)
                 for k, v in mesh.local_rows(batch, rows).items()}
        with spatial.SavedAudit(n) as audit:
            m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
        band_pool.append(tuple(state.pool.imgs.shape))
        saved.append({"whole": audit.whole,
                      "saved_bytes": audit.saved_bytes})
    with auto.gathered(state, optimizer=True):
        res = _step_result(state, m)
        res["ema"] = (None if state.ema is None else
                      {k: v.cpu().clone() for k, v in state.ema.items()})
        res["pool"] = {"imgs": state.pool.imgs.cpu().clone(),
                       "count": int(state.pool.count)}
    return {**res, "steps": metrics, "band_pool": band_pool,
            "saved": saved,
            "coords": {ax: mesh.coord(ax) for ax in mesh.axes}}


def main(path: str, rank: int, world: int, port: str, device: str) -> None:
    torch.set_num_threads(1)
    from pcgan_tpu_torch.parallel.mesh import init_distributed
    mesh = init_distributed(device, backend="gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, local_rank=0)
    try:
        cases = torch.load(path, weights_only=False)
        res = {name: globals()[case["kind"]](mesh, case)
               for name, case in cases.items()}
        torch.save(res, f"{path}.rank{rank}")
    finally:
        mesh.close()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
