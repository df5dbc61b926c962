"""graftlint fixture for the PyTorch port: linted as source, never
imported.

Every rule GL001-GL012 fires exactly once unsuppressed and once more
under an inline suppression, so tests/test_torch_analysis_ast.py can pin
exact per-rule counts; the GL000 cases at the bottom pin the meta-rule
(a reasonless suppression, an unknown rule, a stale suppression, and
suppressions of the entry-level rules GL013 and GL018).
"""

import threading
import time

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from milnce_tpu_torch.data.pipeline import device_prefetch


# ---- GL001 host-sync-hot-loop ------------------------------------------

def hot_loop(loader, device, step_fn):
    prefetch = device_prefetch(loader, device)
    while True:
        batch = next(prefetch, None)
        if batch is None:
            break
        loss = step_fn(batch)
        lv = float(loss)            # GL001: a host sync a step
        n = loss.item()  # graftlint: disable=GL001(fixture: the audited suppressed occurrence)
        del lv, n


# ---- GL002 / GL006 / GL008 in step scope --------------------------------

class Meter:                        # registry-metric stand-in
    def observe(self, value):
        pass


METER = Meter()


class Tower(torch.nn.Module):
    def forward(self, x):
        if x.sum() > 0:             # GL002: bool() of a tensor, a sync
            x = -x
        while x.max() > 1:  # graftlint: disable=GL002(fixture: the audited suppressed occurrence)
            x = x / 2
        print("x", x)               # GL006: formats the values, a sync
        print("shape", x.shape)     # ok: host metadata
        print(x)  # graftlint: disable=GL006(fixture: the audited suppressed occurrence)
        METER.observe(x)            # GL008: converts on the host
        METER.observe(x.mean())  # graftlint: disable=GL008(fixture: the audited suppressed occurrence)
        if x is None:               # ok: identity, no value read
            return x
        return x


# ---- GL003 jit-missing-donate: a per-step copy of the state -------------

def make_train_step(model, optimizer):
    def step(x):
        saved = [p.clone() for p in model.parameters()]  # GL003
        kept = {k: v.clone() for k, v in model.state_dict().items()}  # graftlint: disable=GL003(fixture: the audited suppressed occurrence)
        loss = model(x).sum()
        loss.backward()
        optimizer.step()
        return loss, saved, kept

    return step


# ---- GL004 f64-literal-drift ---------------------------------------------

bad_pad = torch.tensor(0.5, dtype=torch.float64)    # GL004
ok_pad = torch.tensor(0.5, dtype=torch.float32)
sup_pad = np.zeros((4,))  # graftlint: disable=GL004(fixture: the audited suppressed occurrence)


# ---- GL005 unsynced-walltime ---------------------------------------------

def naive_timing(f, x):
    t0 = time.perf_counter()        # GL005: measures the launches
    f(x.cuda())
    return time.perf_counter() - t0


def audited_timing(f, x):
    # graftlint: disable=GL005(fixture: the audited suppressed occurrence)
    t0 = time.perf_counter()
    f(x.cuda())
    return time.perf_counter() - t0


def synced_timing(f, x):
    t0 = time.perf_counter()        # ok: synchronized before the read
    f(x.cuda())
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# ---- GL007 swallowed-broad-except ----------------------------------------

def swallow(f):
    try:
        return f()
    except Exception:               # GL007: error dropped on the floor
        return None


def swallow_suppressed(f):
    try:
        return f()
    except Exception:  # graftlint: disable=GL007(fixture: the audited suppressed occurrence)
        return None


def broad_but_recorded(f, log):
    try:
        return f()
    except Exception as exc:        # ok: the bound exception is recorded
        log(exc)
        return None


# ---- GL009 phantom-mesh-axis ---------------------------------------------

def grid_groups(world):
    mesh = init_device_mesh("cpu", (world // 2, 2),
                            mesh_dim_names=("data", "model"))
    typo = mesh["modle"]            # GL009: no mesh declares 'modle'
    expert = mesh.get_group("expert")  # graftlint: disable=GL009(fixture: the audited suppressed occurrence)
    ok = mesh["model"]
    return typo, expert, ok


# ---- GL010 unguarded-shared-state ----------------------------------------

class UnguardedStats:
    """Thread-shared (owns + acquires a lock): one unguarded shared
    write, one suppressed one, plus the write-once and annotated
    exemptions."""

    def __init__(self):
        self._lock = threading.Lock()
        self.calls = 0
        self.errors = 0
        self.mode = "ladder"            # write-once: lock-free reads ok
        self.depth = 2  # guarded-by: _lock

    def record(self):
        self.calls += 1                 # GL010: unguarded shared write
        with self._lock:
            self.errors += 1            # infers the guard: errors -> _lock

    def snapshot(self):
        with self._lock:
            errs = self.errors
        return {"mode": self.mode, "depth": self.depth, "errors": errs,
                "calls": self.calls}

    def reset(self):
        self.errors = 0  # graftlint: disable=GL010(fixture: the audited suppressed occurrence)


# ---- GL011 lock-order-cycle ----------------------------------------------

_LOCK_A = threading.Lock()
_LOCK_B = threading.Lock()
_LOCK_C = threading.Lock()
_LOCK_D = threading.Lock()


def ordered_ab():
    with _LOCK_A:
        with _LOCK_B:                   # establishes A -> B
            pass


def ordered_ba():
    with _LOCK_B:
        with _LOCK_A:                   # GL011: closes the A/B cycle
            pass


def ordered_cd():
    with _LOCK_C:
        with _LOCK_D:                   # establishes C -> D
            pass


def ordered_dc():
    with _LOCK_D:
        # graftlint: disable=GL011(fixture: the audited suppressed occurrence)
        with _LOCK_C:
            pass


# ---- GL012 blocking-under-lock -------------------------------------------

def copy_under_lock(x):
    with _LOCK_A:
        return x.cpu()                  # GL012: a device copy under A


def sync_under_lock():
    with _LOCK_B:
        torch.cuda.synchronize()  # graftlint: disable=GL012(fixture: the audited suppressed occurrence)


def copy_outside_lock(x):
    with _LOCK_A:
        state = dict(ready=True)        # ok: copy state under the lock,
    del state                           # block after release
    return x.cpu()


# ---- GL000 bad-suppression -------------------------------------------------

x_no_reason = 1  # graftlint: disable=GL001
x_unknown_rule = 2  # graftlint: disable=GL999(no such rule)
x_stale = 3  # graftlint: disable=GL001(fixture: stale — GL001 does not fire here)
x_entry_level = 4  # graftlint: disable=GL013(planner rules pin entries, not source lines)
x_entry_level_numerics = 5  # graftlint: disable=GL018(numerics rules pin entries, not source lines)
