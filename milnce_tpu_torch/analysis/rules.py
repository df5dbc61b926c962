"""graftlint rule catalogue for the PyTorch port (GL000-GL018).

The ids, the names and the suppression syntax are the JAX package's, so
an audit reads the same in both trees::

    x = float(loss)  # graftlint: disable=GL001(display-cadence fetch)

A suppression must carry a non-empty reason; a bare ``disable=GL001`` is
itself a finding (GL000).  Each rule targets what costs a train step or a
serving call in eager PyTorch on an NVIDIA H100: where the JAX pothole
has no eager form (a tracer, a missing donation, a jaxpr), the rule
keeps its id and name and targets the eager pothole of the same cost,
and its rationale says so.  Passes: 1 (``astlint``: GL000-GL009, GL017's
source half), 3 (``concurrency``: GL010-GL012), 4 (``memplan``:
GL013-GL015 on an op trace), 5 (``numerics``: GL016-GL018 on the same
trace).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Rule:
    id: str
    name: str
    summary: str
    rationale: str
    example: str
    fix: str


_RULE_LIST = (
    Rule(
        id="GL000",
        name="bad-suppression",
        summary="malformed or stale graftlint suppression / annotation "
                "comment",
        rationale="A suppression without a reason (or naming an unknown "
                  "rule) silences a finding without saying why.  A stale "
                  "one, whose rule no longer fires on its line, claims "
                  "an exception that no longer exists and would absorb a "
                  "later real finding there.  A `# guarded-by:` naming a "
                  "lock the module does not declare is the same rot.",
        example="x = float(loss)  # graftlint: disable=GL001",
        fix="write `# graftlint: disable=GL001(<why this sync is safe>)`; "
            "delete suppressions whose rule stopped firing; fix typo'd "
            "guarded-by lock names",
    ),
    Rule(
        id="GL001",
        name="host-sync-hot-loop",
        summary="host-blocking call reachable from the training hot loop",
        rationale="float()/int()/bool() of a CUDA tensor, .item(), "
                  ".tolist(), .cpu(), .numpy(), torch.cuda.synchronize() "
                  "and Event.synchronize() block the host until the card "
                  "drains its queue.  In the loop over device_prefetch "
                  "that empties the launch queue every step: the next "
                  "step's kernels cannot be enqueued while the card "
                  "finishes this one, and the card idles for the host's "
                  "dispatch time.",
        example="loss_val = float(loss)  # inside the per-batch loop",
        fix="accumulate on the device; read at display cadence (and "
            "suppress that audited fetch with a reason)",
    ),
    Rule(
        id="GL002",
        name="traced-python-flow",
        summary="Python if/while on a tensor value in step scope",
        rationale="Eager PyTorch has no tracer: `if x > 0:` on a CUDA "
                  "tensor calls bool() on it, a hidden host sync, once "
                  "per step (nn.Module.forward, autograd.Function "
                  "forward/backward, the train step's classes).  It is "
                  "the eager form of a branch on a traced value: the "
                  "step stalls where JAX would have refused to trace.",
        example="if loss.isnan():  # inside forward",
        fix="torch.where / a device-side select; or hoist the decision "
            "to build time (shapes and config are known there)",
    ),
    Rule(
        id="GL003",
        name="jit-missing-donate",
        summary="per-step copy of the parameters or optimizer state in "
                "step scope",
        rationale="JAX donates the consumed train state so the update "
                  "needs no second copy.  Eager PyTorch updates in "
                  "place, and the pothole of the same cost is a copy: "
                  ".clone()/deepcopy of parameters(), state_dict() or "
                  "optimizer.state inside a step doubles the state's "
                  "bytes at the peak and adds their copy to every step.",
        example="saved = [p.clone() for p in model.parameters()]  "
                "# in the step",
        fix="keep the state in place (a fused optimizer's found_inf "
            "skips an update without a copy); an audited copy gets "
            "# graftlint: disable=GL003(<why the copy is needed>)",
    ),
    Rule(
        id="GL004",
        name="f64-literal-drift",
        summary="a tensor or array built in float64",
        rationale="torch.float64 / .double() / torch.tensor(<float>, "
                  "dtype=torch.float64), torch.from_numpy of a "
                  "default-dtype numpy array and np.zeros() without "
                  "dtype= all land in float64.  An f64 operand upcasts "
                  "every op it meets; the H100 runs f64 at a fraction of "
                  "f32's rate and twice its bytes.",
        example="pad = torch.tensor(0.5, dtype=torch.float64)",
        fix="pass dtype= explicitly (torch.float32, or the model's "
            "dtype); a deliberate float64 (a host-side reference) gets "
            "# graftlint: disable=GL004(<why f64>)",
    ),
    Rule(
        id="GL005",
        name="unsynced-walltime",
        summary="wall-clock deltas around CUDA work with no sync or "
                "events between them",
        rationale="Kernel launches are asynchronous: time.perf_counter() "
                  "deltas around a CUDA call measure the launch, not the "
                  "kernel, unless a synchronize or CUDA events sit "
                  "between the two reads.",
        example="t0 = time.perf_counter(); f(x); dt = "
                "time.perf_counter() - t0",
        fix="utils/timing.py (event_ms: CUDA events and the median; "
            "chained_ms: back-to-back launches, one sync) or a "
            "torch.cuda.synchronize() before each read",
    ),
    Rule(
        id="GL006",
        name="print-under-trace",
        summary="print() of a tensor in step scope",
        rationale="print() of a CUDA tensor formats its values, a host "
                  "sync and a device-to-host copy, every step.",
        example="print('loss', loss)  # inside forward",
        fix="log at display cadence outside the step",
    ),
    Rule(
        id="GL007",
        name="swallowed-broad-except",
        summary="broad `except` that drops the error on the floor",
        rationale="A bare/`except Exception:` handler that neither "
                  "re-raises nor records the exception swallows a "
                  "failure silently: a corrupt dataset trains green, a "
                  "flaky checkpoint store loses an epoch with no log "
                  "line.",
        example="except Exception:\n    pass",
        fix="re-raise, bind and use the exception, pass exc_info to a "
            "logging call, or suppress with a reason: "
            "# graftlint: disable=GL007(<why swallowing is correct here>)",
    ),
    Rule(
        id="GL008",
        name="obs-under-trace",
        summary="obs recording in step scope with a tensor argument",
        rationale="Registry counters and span recorders are host I/O; "
                  "handing them a CUDA tensor converts it, a host sync "
                  "per call (per microbatch in the grad-cache step).",
        example="METRICS.observe(loss)  # inside the step",
        fix="record outside the step, at display cadence, from values "
            "already on the host",
    ),
    Rule(
        id="GL009",
        name="phantom-mesh-axis",
        summary="a mesh-dimension name in parallel/ that no DeviceMesh "
                "or ParallelConfig declares",
        rationale="A typo'd axis name (`mesh['modle']`, a sharding-map "
                  "axis string) either raises deep inside a collective "
                  "or, in the sharding map, shards nothing: every "
                  "parameter stays replicated and the 2-D layout pays "
                  "its collectives for no saving.",
        example="group = mesh['modle']",
        fix="name only 'data' and 'model' (ParallelConfig) or an axis a "
            "mesh in the same module declares",
    ),
    Rule(
        id="GL010",
        name="unguarded-shared-state",
        summary="shared mutable attribute accessed outside its lock in a "
                "thread-shared class",
        rationale="The serving and obs layers are a thread mesh (batcher "
                  "workers, HTTP request threads, the index ingest thread, the "
                  "train loop).  A write outside the attribute's guard is "
                  "a data race; a lock-free read of a guarded attribute "
                  "is one too unless the attribute is write-once in "
                  "__init__.",
        example="self._calls[key] = self._calls.get(key, 0) + 1  "
                "# no lock; called from worker AND request threads",
        fix="take the guard around every access; declare it with "
            "`# guarded-by: _lock` when inference cannot see it; anything "
            "else needs a reasoned suppression",
    ),
    Rule(
        id="GL011",
        name="lock-order-cycle",
        summary="cycle in the static lock-acquisition order graph",
        rationale="Thread 1 takes A then B, thread 2 B then A: some "
                  "interleaving deadlocks.  The graph spans same-module "
                  "calls and imported module-level locks "
                  "(DEVICE_DISPATCH_LOCK); analysis/lockrt.py checks the "
                  "same order on live threads.",
        example="# thread 1: with A: with B: ...\n"
                "# thread 2: with B: with A: ...",
        fix="one global order for the locks involved; a provably safe "
            "ordering gets "
            "# graftlint: disable=GL011(<why no interleaving deadlocks>)",
    ),
    Rule(
        id="GL012",
        name="blocking-under-lock",
        summary="blocking call (future.result/join/wait/open/sleep or "
                "device dispatch) while holding a lock",
        rationale="A lock held across a blocking call stalls every "
                  "contender for the wait.  PyTorch's device verbs "
                  "(.to(device), .cuda(), .cpu(), torch.cuda."
                  "synchronize(), Event.synchronize()) block for a copy "
                  "or a drained queue; they are exempt only under a lock "
                  "whose name holds 'dispatch', whose job is to "
                  "serialize device work.",
        example="with self._lock:\n    row = fut.result()",
        fix="move the blocking work out of the critical section; a "
            "deliberate block-under-lock gets "
            "# graftlint: disable=GL012(<why contenders may wait>)",
    ),
    Rule(
        id="GL013",
        name="peak-budget-regression",
        summary="an entry's peak of live bytes drifted from its pin "
                "(op-trace planner)",
        rationale="The full-width step's activations fill most of an "
                  "H100's 80 GB at batch 16.  analysis/memplan.py "
                  "replays each entry's op trace (storage births and "
                  "deaths) and pins the peak, so a kept activation or a "
                  "doubled optimizer tensor fails a test instead of an "
                  "allocation on the card.",
        example="EXPECTED_PEAK_BYTES['train_step_milnce'] drifts +30%",
        fix="read the GL015 contributors; if intended, re-pin "
            "EXPECTED_PEAK_BYTES in the same commit (entry-level rule: "
            "inline suppressions do not apply)",
    ),
    Rule(
        id="GL014",
        name="ineffective-or-missing-donation",
        summary="a large buffer kept alive across the next forward that "
                "freeing would save",
        rationale="Eager PyTorch frees a buffer when its last reference "
                  "goes; the eager form of a missing donation is a "
                  "reference kept: gradients zeroed in place "
                  "(zero_grad(set_to_none=False)) or a saved copy of "
                  "the state outliving the step, both of which sit under "
                  "the next forward's activations at the peak.",
        example="optimizer.zero_grad(set_to_none=False)",
        fix="set gradients to None before the forward; drop saved copies "
            "at the step's end (entry-level rule: inline suppressions do "
            "not apply)",
    ),
    Rule(
        id="GL015",
        name="top-contributor-drift",
        summary="an entry's top-3 peak-memory contributors changed "
                "identity (pinned by name)",
        rationale="A peak inside GL013's tolerance can still change what "
                  "occupies it.  Pinning the top-3 names (parameter and "
                  "buffer names, `state/<param>/exp_avg`, `aten op "
                  "dtype[shape]`) turns that into a readable diff.",
        example="'convolution f32[16,64,32,112,112]' replaces "
                "'state/...exp_avg' at the peak",
        fix="explain the new occupant; if intended, re-pin "
            "EXPECTED_TOP_CONTRIBUTORS in the same commit (entry-level "
            "rule: inline suppressions do not apply)",
    ),
    Rule(
        id="GL016",
        name="low-precision-accumulation",
        summary="sum/mm/bmm/addmm/convolution/collective accumulating in "
                "bf16/f16 at extent >= threshold",
        rationale="bf16 keeps 8 mantissa bits: a sum of N same-sign terms "
                  "loses about log2(N) of them.  The H100's tensor cores "
                  "accumulate in f32 at no cost, so a low-precision "
                  "accumulator is never a speed win.  Pass 5 fires on "
                  "every such op in an entry's trace, and its bf16 "
                  "what-if names the reductions a bf16 model would "
                  "demote.",
        example="x_bf16.sum(0)  # extent 4096",
        fix="accumulate in f32 (.float() before the sum, or an f32 "
            "output); entry-level rule: re-register a deliberate one in "
            "analysis/numerics.py",
    ),
    Rule(
        id="GL017",
        name="unstabilized-exp-domain",
        summary="exp without a max-subtraction guard, or a reduce-sum "
                "division without eps, in a loss module",
        rationale="exp overflows f32 past 88.  Every softmax/logsumexp in "
                  "the losses subtracts a max first, and a division by a "
                  "reduced sum needs a floor.  The source half matches "
                  "exp and division sites in losses/; the trace half "
                  "checks that each exp's operand chain reaches a "
                  "subtraction or a max.",
        example="neg = torch.exp(pairwise).sum(dim=1)",
        fix="subtract the row max (or reuse the logsumexp bound); floor "
            "the denominator; a deliberate site gets "
            "# graftlint: disable=GL017(<why the domain is bounded>)",
    ),
    Rule(
        id="GL018",
        name="dtype-boundary-drift",
        summary="an entry's dtype census (output bytes by dtype) or cast "
                "inventory drifted from the pin",
        rationale="Every dtype boundary should be deliberate: a new cast "
                  "is an upconversion costing bytes, a vanished one a "
                  "demoted accumulator.  Pass 5 pins each entry's census "
                  "and casts and prints the re-pin dict on drift.",
        example="'f32->i32 _to_copy(...)' appears in train_step_milnce",
        fix="explain the moved boundary; if intended, re-pin "
            "EXPECTED_DTYPE_CENSUS / EXPECTED_CASTS in the same commit "
            "(entry-level rule: inline suppressions do not apply)",
    ),
)

RULES: dict[str, Rule] = {r.id: r for r in _RULE_LIST}
RULES_BY_NAME: dict[str, Rule] = {r.name: r for r in _RULE_LIST}


def resolve_rule(token: str) -> Rule | None:
    """Accept either a rule ID ('GL001') or name ('host-sync-hot-loop')."""
    return RULES.get(token) or RULES_BY_NAME.get(token)
