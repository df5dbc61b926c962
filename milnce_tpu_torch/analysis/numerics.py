"""graftlint Pass 5 for the PyTorch port: numerics on an entry's op trace
(``analysis/optrace.py``).

- **the dtype census** — bytes of every op output by dtype, the entry's
  arguments included (:func:`census`);
- **the cast inventory** — ``_to_copy``/``to``/``copy_`` ops that change
  dtype, named by route (``f32->i32``) and by the argument or module
  they act on (:func:`casts`);
- **the f32-residency set** — BatchNorm buffers, Adam's moments and the
  operands of every ``log``/``logsumexp`` must be float32 or wider
  (:func:`residency`);
- **GL016** — ``sum``/``mm``/``bmm``/``addmm``/``convolution``/a
  collective producing bf16/f16 at a reduction extent of at least
  :data:`GL016_MIN_EXTENT` (:func:`low_precision_accumulations`);
- **GL017** (trace half) — an ``exp`` whose operand's producer chain
  reaches no subtraction or max within :data:`GL017_DEPTH` ops
  (:func:`unguarded_exps`); the source half is ``astlint``'s;
- **GL018** — census and casts against ``EXPECTED_DTYPE_CENSUS`` /
  ``EXPECTED_CASTS``, the paste-ready re-pin dict printed on drift
  (:func:`check_pins`);
- **the bf16 what-if** — which f32 accumulations a bf16 model would
  demote (:func:`bf16_what_if`); it only reports.
"""

from __future__ import annotations

from milnce_tpu_torch.analysis.astlint import Finding
from milnce_tpu_torch.analysis.optrace import OpTrace, dtype_name
from milnce_tpu_torch.analysis.rules import RULES

GL016_MIN_EXTENT = 64
GL017_DEPTH = 8
_LOW = {"bf16", "f16"}
_ACCUMULATE = {"sum", "mm", "bmm", "addmm", "convolution", "matmul",
               "mean", "c10d.allreduce_", "c10d.reduce_scatter_",
               "c10d._reduce_scatter_base_", "c10d.reduce_scatter_tensor_coalesced_"}
_GUARDS = {"sub", "sub_", "rsub", "amax", "max", "maximum", "logsumexp",
           "clamp", "clamp_max", "log_softmax", "_log_softmax", "where",
           "minimum", "min"}
_CASTS = {"_to_copy", "to", "copy_", "_copy_from"}
_LOGS = {"log", "logsumexp", "log_softmax", "_log_softmax", "log1p",
         "logaddexp"}


def _nbytes(dtype, shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    import torch

    return n * torch.empty((), dtype=dtype).element_size()


def census(trace: OpTrace) -> dict:
    """``{dtype: bytes}`` over every op output and every argument."""
    out: dict = {}
    for s in trace.all_storages():
        if s.argument:
            out[s.dtype] = out.get(s.dtype, 0) + s.nbytes
    for op in trace.ops:
        for dtype, shape in op.outputs:
            key = dtype_name(dtype)
            out[key] = out.get(key, 0) + _nbytes(dtype, shape)
    return dict(sorted(out.items()))


def _where(trace: OpTrace, op) -> str:
    for key in op.in_keys:
        s = trace.storages.get(key)
        if s is not None and s.argument:
            return s.label
    return op.owner


def casts(trace: OpTrace) -> dict:
    """``{"f32->i32 _to_copy @ <argument or owner>": count}``."""
    out: dict = {}
    for op in trace.ops:
        if op.name not in _CASTS or not op.inputs or not op.outputs:
            continue
        src = op.inputs[-1][0] if op.name == "copy_" else op.inputs[0][0]
        dst = op.outputs[0][0]
        if src == dst:
            continue
        key = (f"{dtype_name(src)}->{dtype_name(dst)} {op.name} @ "
               f"{_where(trace, op)}")
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def residency(trace: OpTrace) -> list:
    """Names of what must stay f32 and is not: BatchNorm statistics,
    Adam's moments (by argument label) and log/logsumexp operands."""
    bad = []
    for s in trace.all_storages():
        if s.argument and (s.label.endswith(("running_mean", "running_var"))
                           or s.label.endswith(("/exp_avg", "/exp_avg_sq"))):
            if s.dtype not in ("f32", "f64"):
                bad.append(f"{s.label} is {s.dtype}")
    for op in trace.ops:
        if op.name in _LOGS:
            for dtype, _ in op.inputs:
                if dtype_name(dtype) in _LOW:
                    bad.append(f"{op.name} operand {dtype_name(dtype)} in "
                               f"{op.owner}")
    return bad


def _extent(op) -> int:
    """How many terms the op sums into an output element."""
    name = op.name
    if name in ("mm", "matmul", "bmm") and op.inputs:
        return int(op.inputs[0][1][-1])
    if name == "addmm" and len(op.inputs) >= 2:
        return int(op.inputs[1][1][-1])
    if name == "convolution" and len(op.inputs) >= 2:
        w = op.inputs[1][1]
        n = 1
        for s in w[1:]:
            n *= int(s)
        return n
    if name in ("sum", "mean") and op.inputs and op.outputs:
        n_in = _count(op.inputs[0][1])
        return n_in // max(_count(op.outputs[0][1]), 1)
    if name.startswith("c10d."):
        return GL016_MIN_EXTENT      # any low-precision collective sum
    return 0


def _count(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _accumulations(trace: OpTrace, low: bool) -> list:
    out = []
    for op in trace.ops:
        if op.name not in _ACCUMULATE or not op.inputs:
            continue
        dtypes = [dtype_name(d) for d, _ in (op.outputs or op.inputs)]
        if any(d in _LOW for d in dtypes) != low:
            continue
        if not low and not any(d == "f32" for d in dtypes):
            continue
        extent = _extent(op)
        if extent >= GL016_MIN_EXTENT:
            out.append(f"{op.name} extent {extent} "
                       f"{'/'.join(sorted(set(dtypes)))} @ {op.owner}")
    return out


def low_precision_accumulations(trace: OpTrace) -> list:
    """GL016 sites: accumulations producing bf16/f16 at extent >= 64."""
    return _accumulations(trace, low=True)


def bf16_what_if(trace: OpTrace) -> list:
    """The f32 accumulations at extent >= 64 that a bf16 model would
    demote, by op, extent and owner (report only)."""
    return _accumulations(trace, low=False)


def unguarded_exps(trace: OpTrace) -> list:
    """GL017 sites: ``exp`` ops whose operand chain (producers, up to
    :data:`GL017_DEPTH` ops back) holds no subtraction, max or
    logsumexp."""
    out = []
    for op in trace.ops:
        if op.name not in ("exp", "exp_"):
            continue
        frontier, seen, guarded = list(op.in_keys), set(), False
        for _ in range(GL017_DEPTH):
            nxt = []
            for key in frontier:
                prod = trace.producer_before(key, op.index)
                if prod is None or prod.index in seen:
                    continue
                seen.add(prod.index)
                if prod.name in _GUARDS:
                    guarded = True
                    break
                nxt.extend(prod.in_keys)
            if guarded or not nxt:
                break
            frontier = nxt
        if not guarded:
            out.append(f"exp @ {op.owner} (op {op.index})")
    return out


# ------------------------------------------------------------ the pins
# Measured on the CPU at the entries' tiny shapes (analysis/
# trace_invariants.py).  Re-pin from the drift message.
EXPECTED_DTYPE_CENSUS = {
    'train_step_milnce': {
        'bool': 769,
        'f32': 35269016,
        'i32': 192,
        'i64': 656640,
        'u8': 49152,
    },
    'train_step_milnce_guarded': {
        'bool': 770,
        'f32': 35327264,
        'i32': 196,
        'i64': 657312,
        'u8': 49152,
    },
    'train_step_milnce_instrumented': {
        'bool': 770,
        'f32': 35327264,
        'i32': 196,
        'i64': 657312,
        'u8': 49152,
    },
    'train_step_curriculum': {
        'bool': 386,
        'f32': 47072320,
        'i32': 100,
        'i64': 1025408,
        'u8': 76800,
    },
    'train_step_milnce_chunked': {
        'bool': 878,
        'f32': 35357312,
        'i32': 196,
        'i64': 658112,
        'u8': 49152,
    },
    'train_step_sdtw3': {
        'bool': 3026,
        'f32': 35704820,
        'i32': 196,
        'i64': 659792,
        'u8': 49152,
    },
    'grad_cache_step_milnce': {
        'bool': 770,
        'f32': 49016032,
        'i32': 388,
        'i64': 1313056,
        'u8': 98304,
    },
    'retrieval_embed': {'f32': 10234560, 'i32': 192, 'i64': 655456, 'u8': 49152},
    'softdtw': {'bool': 1296, 'f32': 59108, 'i64': 1584},
    'serve_embed_ladder': {'f32': 10219968, 'i64': 655456, 'u8': 49152},
    'serve_pool_embed': {'f32': 10219968, 'i64': 655456, 'u8': 49152},
    'serve_quant_embed_ladder': {'f32': 12313876, 'i64': 655456, 'i8': 525248, 'u8': 49152},
    'serve_index_topk': {'bool': 360, 'f32': 7232, 'i32': 5120, 'i64': 13120},
    'serve_live_index': {'bool': 576, 'f32': 11072, 'i32': 8192, 'i64': 20224},
    'train_step_milnce@W2': {
        'bool': 385,
        'f32': 37269568,
        'i32': 96,
        'i64': 328416,
        'u8': 24576,
    },
    'train_step_milnce_guarded@W2': {
        'bool': 386,
        'f32': 37327816,
        'i32': 100,
        'i64': 329088,
        'u8': 24576,
    },
    'grad_cache_step_milnce@W2': {
        'bool': 386,
        'f32': 47086088,
        'i32': 196,
        'i64': 657152,
        'u8': 49152,
    },
    'train_step_milnce_2d': {
        'bool': 385,
        'f32': 37486848,
        'i32': 96,
        'i64': 328416,
        'u8': 24576,
    },
    'train_step_milnce_2d_guarded': {
        'bool': 386,
        'f32': 37545104,
        'i32': 100,
        'i64': 329088,
        'u8': 24576,
    },
    'grad_cache_2d': {
        'bool': 386,
        'f32': 47303376,
        'i32': 196,
        'i64': 657152,
        'u8': 49152,
    },
    'train_step_milnce_2d_fused': {
        'bool': 385,
        'f32': 37540928,
        'i32': 96,
        'i64': 328416,
        'u8': 24576,
    },
    'train_step_milnce_2d_guarded_fused': {
        'bool': 386,
        'f32': 37599184,
        'i32': 100,
        'i64': 329088,
        'u8': 24576,
    },
    'grad_cache_2d_fused': {
        'bool': 386,
        'f32': 47357456,
        'i32': 196,
        'i64': 657152,
        'u8': 49152,
    },
}
EXPECTED_CASTS = {
    'train_step_milnce': {'u8->f32 _to_copy @ arg0': 1},
    'train_step_milnce_guarded': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 1},
    'train_step_milnce_instrumented': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 1},
    'train_step_curriculum': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 1},
    'train_step_milnce_chunked': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 1},
    'train_step_sdtw3': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 1},
    'grad_cache_step_milnce': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 4},
    'retrieval_embed': {'u8->f32 _to_copy @ arg0': 1},
    'softdtw': {},
    'serve_embed_ladder': {'u8->f32 _to_copy @ entry': 1},
    'serve_pool_embed': {'u8->f32 _to_copy @ entry': 1},
    'serve_quant_embed_ladder': {
        'i8->f32 _to_copy @ q0': 1,
        'i8->f32 _to_copy @ q1': 1,
        'i8->f32 _to_copy @ q10': 1,
        'i8->f32 _to_copy @ q11': 1,
        'i8->f32 _to_copy @ q12': 1,
        'i8->f32 _to_copy @ q13': 1,
        'i8->f32 _to_copy @ q14': 1,
        'i8->f32 _to_copy @ q15': 1,
        'i8->f32 _to_copy @ q16': 1,
        'i8->f32 _to_copy @ q17': 1,
        'i8->f32 _to_copy @ q2': 1,
        'i8->f32 _to_copy @ q3': 1,
        'i8->f32 _to_copy @ q4': 1,
        'i8->f32 _to_copy @ q5': 1,
        'i8->f32 _to_copy @ q6': 1,
        'i8->f32 _to_copy @ q7': 1,
        'i8->f32 _to_copy @ q8': 1,
        'i8->f32 _to_copy @ q9': 1,
        'u8->f32 _to_copy @ entry': 1,
    },
    'serve_index_topk': {'i32->i64 _to_copy @ entry': 1},
    'serve_live_index': {'i32->i64 _to_copy @ entry': 1},
    'train_step_milnce@W2': {'u8->f32 _to_copy @ arg0': 1},
    'train_step_milnce_guarded@W2': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 1},
    'grad_cache_step_milnce@W2': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 4},
    'train_step_milnce_2d': {'u8->f32 _to_copy @ arg0': 1},
    'train_step_milnce_2d_guarded': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 1},
    'grad_cache_2d': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 4},
    'train_step_milnce_2d_fused': {'u8->f32 _to_copy @ arg0': 1},
    'train_step_milnce_2d_guarded_fused': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 1},
    'grad_cache_2d_fused': {'f32->i32 _to_copy @ entry': 1, 'u8->f32 _to_copy @ arg0': 4},
}


def audit(trace: OpTrace) -> dict:
    """The numerics of one trace, as plain data."""
    return {"census": census(trace), "casts": casts(trace),
            "residency": residency(trace),
            "gl016": low_precision_accumulations(trace),
            "gl017": unguarded_exps(trace),
            "what_if_bf16": bf16_what_if(trace)}


def check_pins(entry: str, audited: dict, expected_census=None,
               expected_casts=None) -> list[Finding]:
    """GL016-GL018 findings of one entry's audit against its pins (the
    tables' by default); an entry with no pin is a GL018 finding."""
    where = f"<entry:{entry}>"
    out = []
    for site in audited["gl016"]:
        out.append(Finding(where, 0, RULES["GL016"],
                           f"{entry}: low-precision accumulation {site}"))
    for site in audited["gl017"]:
        out.append(Finding(where, 0, RULES["GL017"],
                           f"{entry}: {site} has no max-subtraction guard "
                           "in its operand chain"))
    for site in audited["residency"]:
        out.append(Finding(where, 0, RULES["GL018"],
                           f"{entry}: f32 residency broken: {site}"))
    want = (EXPECTED_DTYPE_CENSUS.get(entry) if expected_census is None
            else expected_census)
    if want != audited["census"]:
        out.append(Finding(where, 0, RULES["GL018"],
                           f"{entry}: dtype census {audited['census']} != "
                           f"pinned {want}"))
    want = EXPECTED_CASTS.get(entry) if expected_casts is None else expected_casts
    if want != audited["casts"]:
        out.append(Finding(where, 0, RULES["GL018"],
                           f"{entry}: cast inventory {audited['casts']} != "
                           f"pinned {want}"))
    return out


def repin_dict(audits: dict) -> str:
    """The paste-ready pin tables of ``{entry: audit}``."""
    cen = {e: a["census"] for e, a in audits.items()}
    cas = {e: a["casts"] for e, a in audits.items()}
    return f"EXPECTED_DTYPE_CENSUS = {cen!r}\nEXPECTED_CASTS = {cas!r}"
