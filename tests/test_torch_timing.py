"""``milnce_tpu_torch/utils/timing.py``: the chained protocol's
differencing under a fake clock, and both protocols on the CPU device
(the host clock there; CUDA events only on a card); and which profiler
sessions ``ops/rows_probe.py`` reads a call's device time from."""

import pytest
import torch

from milnce_tpu_torch.ops import rows_probe
from milnce_tpu_torch.utils import timing


class FakeClock:
    """Each call of ``fn`` costs ``per_call`` seconds; each synchronize
    ``sync_cost`` (the fixed cost the differencing cancels)."""

    def __init__(self, per_call, sync_cost):
        self.t, self.per_call, self.sync_cost = 0.0, per_call, sync_cost
        self.calls = self.syncs = 0

    def __call__(self):
        return self.t

    def fn(self):
        self.calls += 1
        self.t += self.per_call

    def sync(self):
        self.syncs += 1
        self.t += self.sync_cost


@pytest.mark.parametrize("n,k1", [(20, 4), (7, 1), (100, 16)])
def test_chained_ms_cancels_the_fixed_cost(n, k1):
    clock = FakeClock(per_call=0.0025, sync_cost=0.5)
    ms = timing.chained_ms(clock.fn, n=n, k1=k1, device="cpu", reps=3,
                           clock=clock, sync=clock.sync)
    assert ms == pytest.approx(2.5, rel=1e-9)
    # the warm run, then reps pairs of runs of k1 + n and k1 calls
    assert clock.calls == k1 + 3 * (2 * k1 + n)
    assert clock.syncs == 2 * (1 + 3 * 2)


def test_chained_ms_never_negative():
    clock = FakeClock(per_call=0.0, sync_cost=0.1)
    assert timing.chained_ms(clock.fn, n=5, k1=2, device="cpu",
                             clock=clock, sync=clock.sync) == 0.0


def test_event_ms_on_the_cpu_device():
    calls = []
    x = torch.ones(64)

    def fn():
        calls.append(1)
        return (x * 2).sum()

    ms = timing.event_ms(fn, reps=5, warm=2, device="cpu")
    assert ms >= 0.0 and len(calls) == 7


def test_chained_ms_on_the_cpu_device():
    x = torch.ones(256)
    assert timing.chained_ms(lambda: x.exp().sum(), n=10, k1=2,
                             device="cpu") >= 0.0


@pytest.mark.parametrize("got,want", [
    ({"k": (40, 400.0)}, 0.02),                  # 2 launches a call
    ({"k": (38, 380.0)}, 0.02),                  # MAX_DROPPED lost
    ({"k": (37, 370.0)}, None),                  # one more lost
    ({"k": (41, 410.0)}, None),                  # a stray launch
    ({"k": (20, 100.0), "j": (21, 50.0)}, None),
    ({"k": (20, 100.0), "j": (19, 38.0)}, 0.007),
    ({}, None),                                  # no kernel matched
], ids=["exact", "dropped", "too-many-dropped", "surplus", "one-surplus",
        "two-kernels", "none"])
def test_profiler_session_counts_only_without_surplus(got, want):
    ms = rows_probe.session_ms(got, reps=20)
    assert ms == (None if want is None else pytest.approx(want, rel=1e-12))
