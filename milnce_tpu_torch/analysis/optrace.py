"""The port's program representation: an op trace of one call of an
entry (the counterpart of ``jax.make_jaxpr`` for the analysis passes).

:class:`OpTrace` is a ``TorchDispatchMode``: every aten op that runs
under it, and every c10d collective, passes through it once, on the
calling thread and on the autograd engine's threads alike (the engine
carries the mode's thread-local state to them).  For each it records:

- the op's name and its tensor inputs' and outputs' dtypes and shapes;
- its owner: the module path of the innermost module whose forward is
  running (global forward hooks), else ``backward:<autograd node>``
  while the engine runs a node, else the region (``optimizer`` inside
  ``optimizer.step``, else ``entry``);
- each output storage it creates, with its bytes.  A storage is keyed by
  its ``StorageImpl`` (``untyped_storage()._cdata``), so views count
  once, and a weak reference on it records its death, when the last
  tensor on it is collected.

The hand kernels launch through ``ctypes``, which no dispatch mode sees:
their wrappers hand each launch to ``ops/cuda_build.py``'s launch hooks
(``check_launch`` on the card, ``note_launch`` where a wrapper plans a
launch on ``meta``), and the trace records it in order as a ``kernel``
event.  A tensor-to-Python conversion dispatches
``aten._local_scalar_dense``, and a device-to-host copy is a
``_to_copy``/``copy_`` into a CPU tensor from another device: both are
the trace's ``sync`` events.

The same code runs on the CPU (the tests), on the ``meta`` device (the
planner, at full width with no card and no allocation) and on the card.
On meta the fused optimizers' and the finite guard's multi-tensor ops,
which have no meta kernels, are recorded and skipped: they only write
in place.  :func:`meta_fused` lets PyTorch's fused Adam and SGD take
meta parameters.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import weakref

import torch
import torch.optim.optimizer as optim_base
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from milnce_tpu_torch.ops import cuda_build

# in-place multi-tensor ops with no meta kernel: recorded, skipped on meta
_INPLACE_NO_META = {"_fused_adam_", "_fused_adamw_", "_fused_sgd_",
                    "_amp_foreach_non_finite_check_and_unscale_"}
_COPIES = {"_to_copy", "copy_", "to", "_copy_from"}


def short_name(func) -> str:
    """``aten.mm.default`` -> ``mm``; ``c10d.allreduce_.default`` ->
    ``c10d.allreduce_``."""
    ns = func.namespace
    base = func._schema.name.split("::")[-1]
    return base if ns == "aten" else f"{ns}.{base}"


_SHORT = {"float32": "f32", "float64": "f64", "float16": "f16",
          "bfloat16": "bf16", "int64": "i64", "int32": "i32", "int16": "i16",
          "int8": "i8", "uint8": "u8", "bool": "bool"}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``f32``."""
    name = str(dtype).replace("torch.", "")
    return _SHORT.get(name, name)


def aval(dtype, shape) -> str:
    """``f32[16,512]``, the label of a buffer of that dtype and shape."""
    return f"{dtype_name(dtype)}[{','.join(str(int(s)) for s in shape)}]"


@dataclasses.dataclass
class Op:
    """One event of a trace: an aten op, a collective, a sync or a hand
    kernel's launch (``kind``)."""
    index: int
    name: str
    kind: str                   # op | collective | sync | kernel
    owner: str
    inputs: tuple = ()          # ((dtype, shape), ...)
    outputs: tuple = ()
    in_keys: tuple = ()         # storage keys read
    out_keys: tuple = ()        # storage keys written
    clock: int = 0              # the birth/death clock when it started


@dataclasses.dataclass
class Storage:
    """One storage's life in the trace: ``born``/``died`` are positions
    on the trace's clock of births and deaths (``died`` None: alive at
    the end)."""
    key: int
    nbytes: int
    born: int
    died: int | None
    label: str
    argument: bool = False
    dtype: str = ""             # of the tensor it was first seen under
    returned: bool = False      # a result of the traced call


def _tensors(tree) -> list:
    leaves, _ = tree_flatten(tree)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def _key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):   # no storage (sparse...)
        return None


class OpTrace(TorchDispatchMode):
    """Record one call under ``with OpTrace(model) as trace:``.
    ``model``'s ``named_modules()`` name the owners.  Register the
    entry's arguments first (:meth:`argument`), so their bytes count
    from the start; a storage first seen as an input later is added at
    first sight under the label ``unregistered``."""

    def __init__(self, model: torch.nn.Module | None = None):
        super().__init__()
        self.ops: list[Op] = []
        self.storages: dict[int, Storage] = {}
        self.live: dict[int, Storage] = {}
        self.clock = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_clock = 0
        self.region_name = "entry"
        self._names = ({id(m): name or "model"
                        for name, m in model.named_modules()}
                       if model is not None else {})
        self._stack: list[str] = []
        self._hooks: list = []
        self._writers: dict[int, list] = {}
        self._dead: list[Storage] = []
        self.closed = False

    # ---- the clock of births and deaths -------------------------------

    def _tick(self) -> int:
        self.clock += 1
        return self.clock

    def _born(self, t: torch.Tensor, label: str,
              argument: bool) -> Storage | None:
        key = _key(t)
        if key is None:
            return None
        storage = t.untyped_storage()
        nbytes = storage.nbytes()
        rec = self.live.get(key)
        if rec is not None:
            if nbytes > rec.nbytes:             # resized in place
                self.live_bytes += nbytes - rec.nbytes
                rec.nbytes = nbytes
                self._mark_peak()
            return rec
        rec = Storage(key, nbytes, self._tick(), None, label, argument,
                      dtype_name(t.dtype))
        self.storages.setdefault(key, rec)
        if self.storages[key] is not rec:         # a key reused after a death
            self._dead.append(self.storages[key])
            self.storages[key] = rec
        self.live[key] = rec
        self.live_bytes += nbytes
        self._mark_peak()
        weakref.finalize(storage, self._die, key, rec)
        return rec

    def _die(self, key: int, rec: Storage) -> None:
        if self.closed:                 # after the call: alive at its end
            return
        if self.live.get(key) is rec:
            del self.live[key]
            rec.died = self._tick()
            self.live_bytes -= rec.nbytes

    def _mark_peak(self) -> None:
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes, self.peak_clock = self.live_bytes, self.clock

    # ---- the entry's arguments and labels -----------------------------

    def argument(self, name: str, tensor: torch.Tensor) -> None:
        """Register an entry argument's storage under ``name``."""
        rec = self._born(tensor, name, True)
        if rec is not None:
            rec.label, rec.argument = name, True

    def arguments(self, named) -> None:
        for name, tensor in named:
            self.argument(name, tensor)

    def label(self, name: str, tensor: torch.Tensor) -> None:
        """Name a storage the trace already holds (an optimizer moment
        born in the traced call)."""
        key = _key(tensor)
        if key in self.storages:
            self.storages[key].label = name

    # ---- owners and regions -------------------------------------------

    def owner(self) -> str:
        if self._stack:
            return self._stack[-1]
        node = torch._C._current_autograd_node()
        if node is not None:
            return f"backward:{node.name()}"
        return self.region_name

    def _pre(self, module, _inputs):
        name = self._names.get(id(module))
        if name is not None:
            self._stack.append(name)

    def _post(self, module, _inputs, _output):
        if self._names.get(id(module)) is not None and self._stack:
            self._stack.pop()

    def _opt_pre(self, _opt, _args, _kwargs):
        self._opt_region = self.region_name
        self.region_name = "optimizer"

    def _opt_post(self, _opt, _args, _kwargs):
        self.region_name = getattr(self, "_opt_region", "entry")

    def _kernel(self, name: str) -> None:
        self.ops.append(Op(len(self.ops), name, "kernel", self.owner(),
                           clock=self.clock))

    def __enter__(self):
        mod = torch.nn.modules.module
        self._hooks = [mod.register_module_forward_pre_hook(self._pre),
                       mod.register_module_forward_hook(self._post),
                       optim_base.register_optimizer_step_pre_hook(
                           self._opt_pre),
                       optim_base.register_optimizer_step_post_hook(
                           self._opt_post)]
        cuda_build.LAUNCH_HOOKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.closed = True
            for handle in self._hooks:
                handle.remove()
            self._hooks = []
            if self._kernel in cuda_build.LAUNCH_HOOKS:
                cuda_build.LAUNCH_HOOKS.remove(self._kernel)

    # ---- the ops ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = short_name(func)
        ins = _tensors((args, kwargs))
        for t in ins:
            if _key(t) not in self.live:
                self._born(t, "unregistered", False)
        in_keys = tuple(_key(t) for t in ins)
        kind = self._kind(name, ins, args, kwargs)
        meta_skip = (name in _INPLACE_NO_META
                     and any(t.is_meta for t in ins))
        clock = self.clock
        out = None if meta_skip else func(*args, **kwargs)
        outs = _tensors(out)
        index = len(self.ops)
        out_keys = []
        for t in outs:
            self._born(t, f"{name} {aval(t.dtype, t.shape)}", False)
            out_keys.append(_key(t))
        written = out_keys or ([k for k in in_keys[:1]]
                               if name.endswith("_") else [])
        self.ops.append(Op(index, name, kind, self.owner(),
                           tuple((t.dtype, tuple(t.shape)) for t in ins),
                           tuple((t.dtype, tuple(t.shape)) for t in outs),
                           in_keys, tuple(written), clock))
        for k in written:
            self._writers.setdefault(k, []).append(index)
        return out

    @staticmethod
    def _kind(name, ins, args, kwargs) -> str:
        if name.startswith("c10d."):
            return "collective"
        if name == "_local_scalar_dense":
            return "sync"
        if name in _COPIES and ins:
            src = ins[-1] if name == "copy_" else ins[0]
            dst_dev = kwargs.get("device")
            if name == "copy_":
                dst_dev = ins[0].device
            if (dst_dev is not None and torch.device(dst_dev).type == "cpu"
                    and src.device.type not in ("cpu", "meta")):
                return "sync"
        return "op"

    # ---- reading the trace ---------------------------------------------

    def producer_before(self, key, index: int) -> Op | None:
        """The last op before op ``index`` that wrote storage ``key``."""
        writers = self._writers.get(key, [])
        i = bisect.bisect_left(writers, index)
        return self.ops[writers[i - 1]] if i else None

    def all_storages(self) -> list[Storage]:
        return self._dead + list(self.storages.values())

    def live_at(self, clock: int) -> list[Storage]:
        return [s for s in self.all_storages()
                if s.born <= clock and (s.died is None or s.died > clock)]

    def argument_bytes(self) -> int:
        return sum(s.nbytes for s in self.all_storages() if s.argument)

    def events(self, kind: str) -> list[Op]:
        return [op for op in self.ops if op.kind == kind]

    def kernels(self) -> dict:
        out: dict = {}
        for op in self.events("kernel"):
            out[op.name] = out.get(op.name, 0) + 1
        return out

    def collectives(self) -> dict:
        out: dict = {}
        for op in self.events("collective"):
            base = op.name.split(".", 1)[1]
            out[base] = out.get(base, 0) + 1
        return out

    def syncs(self) -> list[Op]:
        return self.events("sync")


@contextlib.contextmanager
def meta_fused():
    """Let PyTorch's fused Adam and SGD take ``meta`` parameters (their
    device check knows no meta); the trace skips their kernels there."""
    import torch.optim.adam as adam_mod
    import torch.optim.sgd as sgd_mod

    real = adam_mod._device_dtype_check_for_fused

    def check(p, cuda_unsupported=False):
        if p.is_meta:
            return
        real(p, cuda_unsupported)

    adam_mod._device_dtype_check_for_fused = check
    sgd_mod._device_dtype_check_for_fused = check
    try:
        yield
    finally:
        adam_mod._device_dtype_check_for_fused = real
        sgd_mod._device_dtype_check_for_fused = real


def state_arguments(model: torch.nn.Module, optimizer=None) -> list:
    """``(name, tensor)`` of a train state: parameters and buffers by
    name, each parameter's gradient (``grad/<name>``) and optimizer
    tensors (``state/<name>/<key>``)."""
    out = list(model.named_parameters()) + list(model.named_buffers())
    names = {id(p): n for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        if p.grad is not None:
            out.append((f"grad/{n}", p.grad))
    if optimizer is not None:
        for p, st in optimizer.state.items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    out.append((f"state/{names.get(id(p), '?')}/{k}", v))
    return out


def trace_call(fn, args: tuple = (), model=None, optimizer=None,
               named: list | None = None):
    """Run ``fn(*args)`` once under an :class:`OpTrace` with the train
    state of ``model``/``optimizer`` and the tensors of ``args``
    (``arg<i>``) registered as arguments; optimizer tensors born in the
    call are named after it.  -> (trace, fn's result)."""
    trace = OpTrace(model)
    if model is not None:
        trace.arguments(state_arguments(model, optimizer))
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor):
            trace.argument(f"arg{i}", a)
    for name, t in named or ():
        trace.argument(name, t)
    with trace:
        out = fn(*args)
    if model is not None:
        for name, t in state_arguments(model, optimizer):
            trace.label(name, t)
    for t in _tensors(out):
        key = _key(t)
        if key in trace.storages and not trace.storages[key].argument:
            trace.storages[key].returned = True
    return trace, out
