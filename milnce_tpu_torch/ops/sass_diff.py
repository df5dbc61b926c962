"""Compare two builds of a kernel library kernel by kernel, by their SASS:
``python -m milnce_tpu_torch.ops.sass_diff OLD.so NEW.so``.

Runs ``cuobjdump -sass`` (the CUDA toolkit's) on both shared libraries,
splits each listing into its kernels and prints one line a kernel:
``same`` where the two builds' SASS is identical, ``differs`` where it is
not, ``only in old`` / ``only in new`` where one build lacks it, then the
kernel's name (demangled where ``c++filt`` is found).  nvcc names a
source's anonymous namespace ``_GLOBAL__N__<hash>_`` with a hash of the
source's contents, so that hash is zeroed in every name and listing
before they are compared (digit for digit, so that the mangled names
keep their lengths and still demangle).  It shows which instances of an
edited kernel template compile to the code they compiled to before (for
``csrc/milnce_stream.cu``: the f32 instances, where a change meant only
for the bf16 ones must leave them as they were).
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

_HASHED = re.compile(r"(?<=_GLOBAL__N__)[0-9a-f]+(?=_)")
_FUNCTION = re.compile(r"\n\s*Function : (\S+)\n")


def split_functions(listing: str) -> dict[str, str]:
    """{kernel name: its SASS} of one ``cuobjdump -sass`` listing, the
    anonymous namespace's hash zeroed in both."""
    listing = _HASHED.sub(lambda m: "0" * len(m.group()), listing)
    parts = _FUNCTION.split(listing)
    return {parts[i]: parts[i + 1] for i in range(1, len(parts) - 1, 2)}


def compare(old: dict[str, str], new: dict[str, str]) -> list[tuple[str, str]]:
    """(state, name) of every kernel of either build, sorted by name."""
    out = []
    for name in sorted(old.keys() | new.keys()):
        if name not in new:
            state = "only in old"
        elif name not in old:
            state = "only in new"
        else:
            state = "same" if old[name] == new[name] else "differs"
        out.append((state, name))
    return out


def _cuobjdump() -> str:
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def _demangled(names: list[str]) -> list[str]:
    if not names or not shutil.which("c++filt"):
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            for n in out]


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print("usage: sass_diff OLD.so NEW.so", file=sys.stderr)
        return 2
    builds = [split_functions(subprocess.run(
        [_cuobjdump(), "-sass", path], capture_output=True, text=True,
        check=True, timeout=600).stdout) for path in argv]
    rows = compare(*builds)
    for (state, _), name in zip(rows, _demangled([n for _, n in rows])):
        print(f"{state:12s} {name}")
    counts = {s: sum(st == s for st, _ in rows)
              for s in ("same", "differs", "only in old", "only in new")}
    print(", ".join(f"{n} {s}" for s, n in counts.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
