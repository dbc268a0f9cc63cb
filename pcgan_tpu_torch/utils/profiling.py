"""Profiling hooks of the port (counterpart of ``pcgan_tpu/utils/profiling.py``).

- ``trace(logdir, device)``: a ``torch.profiler`` trace of the region (CPU
  activity, plus CUDA activity on the card), written as a chrome trace to
  ``{logdir}/trace.json``; with ``with_flops`` it also records each op's
  input shapes and writes, per ATen op call (keyed by the trace's
  ``External id``), its FLOPs and the bytes it must move to
  ``{logdir}/op_costs.json`` (``op_cost``; ``tools/profile_step.py
  mine_trace`` reads both). It enables ``utils/tracing.py``'s recorder
  for the region, so the program's spans are named ranges on the trace's
  timeline.
- ``timed(fn)``: the wall time of a call, synchronized on the card when its
  result holds a CUDA tensor.
"""

from __future__ import annotations

import ast
import contextlib
import json
import math
import os
import time
from typing import Callable

import torch

from pcgan_tpu_torch.utils import tracing

TRACE_FILE = "trace.json"
COSTS_FILE = "op_costs.json"

# the trace's "Input type" names of tensors, and their element bytes
_ITEMSIZE = {"double": 8, "float": 4, "c10::Half": 2, "c10::BFloat16": 2,
             "long int": 8, "int": 4, "short int": 2, "signed char": 1,
             "unsigned char": 1, "bool": 1, "c10::complex<float>": 8}
# a TensorList records no dtype: the optimizers' lists are the f32 params
# and their moments; any other list is counted at 2 bytes an element (the
# narrowest float the port computes in), which can only lower the floor
_LIST_ITEMSIZE = 2
_OPTIMIZER_LIST_ITEMSIZE = 4

# out-of-place elementwise ops: the output has the inputs' broadcast shape
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "where", "neg", "abs", "relu",
    "leaky_relu", "tanh", "sigmoid", "exp", "log", "log1p", "sqrt", "rsqrt",
    "pow", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "sign",
    "erf", "erfc", "gelu", "silu", "softplus", "hardtanh", "square",
    "reciprocal", "lerp", "addcmul", "addcdiv", "threshold_backward",
    "leaky_relu_backward", "tanh_backward", "sigmoid_backward",
    "gelu_backward", "silu_backward", "hardtanh_backward", "masked_fill",
    "nan_to_num", "floor", "ceil", "round", "trunc", "fmod", "remainder"}
# comparisons: a bool output of the broadcast shape
_COMPARE = {"eq", "ne", "lt", "le", "gt", "ge", "isnan", "isinf",
            "logical_and", "logical_or", "logical_not", "bitwise_and",
            "bitwise_or", "bitwise_not"}
# an output of the first input's shape and dtype
_SAME_AS_FIRST = {"_softmax", "_log_softmax", "_softmax_backward_data",
                  "_log_softmax_backward_data", "flip", "roll",
                  "native_dropout_backward", "native_batch_norm",
                  "native_group_norm", "native_layer_norm",
                  "native_batch_norm_backward", "native_group_norm_backward",
                  "native_layer_norm_backward"}
# ops that only write their first input
_WRITE_ONLY = {"fill_", "zero_", "normal_", "uniform_", "bernoulli_",
               "random_", "exponential_", "geometric_", "cauchy_",
               "log_normal_"}
# ops that read only part of their first input (the rows the index picks):
# only the index tensors count
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "masked_select"}
# ops that write only part of their first input: the index tensors and the
# values (their last tensor input) are read, the values' size written
_SCATTERS = {"index_put_", "_index_put_impl_", "index_add_", "scatter_",
             "scatter_add_", "index_copy_", "put_"}
# (padding, stride, dilation, groups, transposed, output_padding) argument
# positions of the convolutions; transposed is a bool, or the position of
# a bool argument
_CONVS = {
    "cudnn_convolution": (2, 3, 4, 5, False, None),
    "cudnn_convolution_transpose": (2, 4, 5, 6, True, 3),
    "convolution": (4, 3, 5, 8, 6, 7),
    "_convolution": (4, 3, 5, 8, 6, 7),
    "convolution_overrideable": (4, 3, 5, 8, 6, 7),
    "mkldnn_convolution": (3, 4, 5, 6, False, None),
    "_slow_conv2d_forward": (5, 4, None, None, False, None),
    "slow_conv_transpose2d": (5, 4, 7, None, True, 6),
}
_MATMULS = {"mm", "addmm", "bmm", "baddbmm", "_addmm_activation"}
_PADS = {"reflection_pad2d", "replication_pad2d", "constant_pad_nd"}


def _literal(v, default=None):
    try:
        return ast.literal_eval(v) if isinstance(v, str) and v else default
    except (ValueError, SyntaxError):
        return default


def _touched(dims, strides) -> int:
    """Elements a strided tensor spans: a dimension of stride 0 (an
    expanded one) is read once."""
    if strides and len(strides) == len(dims):
        return math.prod(d for d, st in zip(dims, strides) if st != 0)
    return math.prod(dims)


def op_cost(name: str, args: dict, profiler_flops: float = 0.0) -> tuple:
    """(FLOPs, bytes read per tensor input, bytes written) of one ATen op
    call from its trace args (``Input Dims``, ``Input type``, ``Input
    Strides``, ``Concrete Inputs``): each input read once, each output
    written once. An output's size follows from the op (its inputs'
    broadcast for elementwise ops, the conv's geometry, the matmul's m x
    n); where it cannot be told from the shapes (reductions, unknown ops)
    only the inputs count, so the floor can only be low. The FLOPs are
    ``profiler_flops`` where the profiler counted the call, else the conv
    and matmul FLOPs from the shapes; elementwise FLOPs are not counted
    (their bytes bind)."""
    op = name.split("::", 1)[-1]
    dims = args.get("Input Dims") or []
    types = args.get("Input type") or []
    strides = args.get("Input Strides") or []
    conc = args.get("Concrete Inputs") or []
    tensors, lists = {}, {}         # position -> (elements, itemsize, dims)
    for i, (d, t) in enumerate(zip(dims, types)):
        st = strides[i] if i < len(strides) else None
        if t in _ITEMSIZE:
            tensors[i] = (_touched(d, st), _ITEMSIZE[t], d)
        elif t == "TensorList":
            size = (_OPTIMIZER_LIST_ITEMSIZE
                    if op.startswith(("_fused_", "_foreach_"))
                    else _LIST_ITEMSIZE)
            sts = st if isinstance(st, list) and len(st) == len(d) else [
                None] * len(d)
            lists[i] = sum(_touched(x, y) for x, y in zip(d, sts)) * size
    nbytes = {i: n * sz for i, (n, sz, _) in tensors.items()}
    reads = {**nbytes, **lists}
    first = min(tensors) if tensors else None
    flops, out = 0.0, 0
    if (op == "copy_" or op in _WRITE_ONLY) and first is not None:
        out = reads.pop(first)       # written, not read
    elif op.startswith("_fused_adam"):
        # params, grads, exp_avgs, exp_avg_sqs, ...: writes 0, 2 and 3
        out = sum(lists.get(i, 0) for i in (0, 2, 3))
    elif op.startswith("_foreach_") and op.endswith("_"):
        out = lists.get(0, 0)
    elif op in _SCATTERS and len(tensors) >= 2:
        reads.pop(first)
        out = nbytes[max(tensors)]
    elif op.endswith("_") and first is not None:
        out = nbytes[first]
    elif op in _ELEMENTWISE or op in _COMPARE:
        shapes = [d for _, _, d in tensors.values()]
        if shapes:
            size = 1 if op in _COMPARE else max(
                sz for _, sz, _ in tensors.values())
            try:
                numel = math.prod(torch.broadcast_shapes(
                    *[tuple(s) for s in shapes]))
            except RuntimeError:     # an empty input: nothing broadcasts
                numel = 0
            out = numel * size
    elif op in _SAME_AS_FIRST and first is not None:
        out = math.prod(tensors[first][2]) * tensors[first][1]
    elif op in ("cat", "stack"):
        out = sum(reads.values())
    elif op in _GATHERS and first is not None:
        reads.pop(first)
    elif op in _PADS and first is not None:
        d, pads = tensors[first][2], _literal(conc[1] if len(conc) > 1
                                              else "", [])
        grown = list(d)
        for j in range(len(pads) // 2):
            grown[-1 - j] += pads[2 * j] + pads[2 * j + 1]
        out = math.prod(grown) * tensors[first][1]
    elif op in _CONVS and len(tensors) >= 2:
        flops, out = _conv(op, tensors, conc)
    elif op == "convolution_backward" and len(tensors) >= 3:
        flops, reads, out = _conv_backward(tensors, conc)
    elif op in _MATMULS and len(tensors) >= 2:
        a, b = [tensors[i][2] for i in sorted(tensors)[-2:]]
        m, k, n = a[-2], a[-1], b[-1]
        batch = math.prod(a[:-2])
        flops = 2.0 * batch * m * n * k
        out = batch * m * n * tensors[sorted(tensors)[-1]][1]
    if profiler_flops:
        flops = float(profiler_flops)
    return flops, [float(reads[i]) for i in sorted(reads)], float(out)


def _conv(op: str, tensors: dict, conc: list) -> tuple:
    """(FLOPs, output bytes) of a forward convolution."""
    pi, si, di, gi, tr, opi = _CONVS[op]
    get = (lambda i, default: default if i is None or i >= len(conc)
           else _literal(conc[i], default))
    (xn, xs, x), (_, _, w) = [tensors[i] for i in sorted(tensors)[:2]]
    spatial = len(x) - 2
    pad = get(pi, [0] * spatial)
    stride = get(si, [1] * spatial)
    dil = get(di, [1] * spatial)
    groups = get(gi, 1) or 1
    transposed = tr if isinstance(tr, bool) else bool(get(tr, False))
    if transposed:
        outpad = get(opi, [0] * spatial)
        cout = w[1] * groups
        size = [(x[2 + j] - 1) * stride[j] - 2 * pad[j]
                + dil[j] * (w[2 + j] - 1) + outpad[j] + 1
                for j in range(spatial)]
        flops = 2.0 * math.prod(x) * math.prod(w) / w[0]
    else:
        cout = w[0]
        size = [(x[2 + j] + 2 * pad[j] - dil[j] * (w[2 + j] - 1) - 1)
                // stride[j] + 1 for j in range(spatial)]
        flops = 2.0 * x[0] * cout * math.prod(size) * math.prod(w) / w[0]
    return flops, x[0] * cout * math.prod(size) * xs


def _conv_backward(tensors: dict, conc: list) -> tuple:
    """(FLOPs, {position: bytes read}, bytes written) of
    ``convolution_backward(grad_output, input, weight, ..., transposed,
    ..., output_mask)``: each requested gradient (input, weight) is
    ``2*N*K*C*R*S*P*Q`` FLOPs; the data gradient reads grad_output and the
    weight, the weight gradient grad_output and the input."""
    gi, xi, wi = sorted(tensors)[:3]
    (gn, gs, g), (xn, xs, x), (wn, ws, w) = [tensors[i] for i in (gi, xi,
                                                                  wi)]
    transposed = bool(_literal(conc[7] if len(conc) > 7 else "", False))
    mask = _literal(conc[10] if len(conc) > 10 else "", [True, True, False])
    macs = (math.prod(x) if transposed else math.prod(g)) * math.prod(w) / w[0]
    flops = 2.0 * macs * (int(bool(mask[0])) + int(bool(mask[1])))
    reads, out = {gi: gn * gs}, 0
    if mask[0]:
        reads[wi] = wn * ws
        out += math.prod(x) * xs
    if mask[1]:
        reads[xi] = xn * xs
        out += math.prod(w) * ws
    if len(mask) > 2 and mask[2]:
        out += (w[1] if transposed else w[0]) * gs
    return flops, reads, out


def op_costs(events, flops_by_id=None) -> dict:
    """{External id: {"op", "flops", "bytes", "reads", "writes"}} for
    every ATen op call of a chrome trace's events that moves bytes or does
    FLOPs (``bytes`` = the reads, one per tensor input, plus the writes).
    ``flops_by_id``: the profiler's FLOP count per call, by the same id."""
    flops_by_id = flops_by_id or {}
    out = {}
    for e in events:
        args = e.get("args", {})
        if e.get("cat") != "cpu_op" or "External id" not in args:
            continue
        ext = args["External id"]
        fl, reads, writes = op_cost(e["name"], args, flops_by_id.get(ext, 0))
        if fl or sum(reads) or writes:
            out[str(ext)] = {"op": e["name"], "flops": fl,
                             "bytes": sum(reads) + writes, "reads": reads,
                             "writes": writes}
    return out


@contextlib.contextmanager
def trace(logdir: str, device="cpu", with_flops: bool = False):
    """Profile the body; yields the ``torch.profiler.profile``. On the card
    the device is synchronized before the trace stops, so the body's
    kernels are in it. The span recorder runs for the body (its spans are
    ranges in the trace) and is drained after it. The files are written
    only when the body completes."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, with_flops=with_flops,
                 record_shapes=with_flops) as prof:
        tracing.enable(annotate=True)
        try:
            yield prof
            if cuda:
                torch.cuda.synchronize(device)
        finally:
            tracing.disable()
            tracing.drain()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if with_flops:
        # a FunctionEvent's id is its op's External id in the trace
        counted = {e.id: e.flops for e in prof.events() if e.flops}
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        with open(os.path.join(logdir, COSTS_FILE), "w") as f:
            json.dump(op_costs(events, counted), f)


def _sync_outputs(out) -> None:
    leaves = torch.utils._pytree.tree_leaves(out)
    for dev in {t.device for t in leaves
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def timed(fn: Callable) -> Callable:
    """Returns wrapped(*a, **k) -> (result, seconds) with device sync."""

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        _sync_outputs(out)
        return out, time.perf_counter() - t0

    return wrapped
