"""``ops/sass_diff.py`` on hand-written ``cuobjdump -sass`` listings: the
anonymous namespace's hash, which nvcc derives from the source, is zeroed
in names and code, so the same kernel in two builds of edited sources
compares as the same and its mangled name keeps its length; each
kernel's state in the comparison."""

import pytest

from milnce_tpu_torch.ops.sass_diff import compare, split_functions

_LISTING = """
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _ZN49_GLOBAL__N__{h}_16_k_cu_4930aeb14rows1kILi1EfEEvPf
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   {a} ;
\t\t..........


\t\tFunction : _ZN49_GLOBAL__N__{h}_16_k_cu_4930aeb14rows1kILi1E13__nv_bfloat16EEvPf
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   {b} ;
        /*0020*/                   CALL `(_ZN49_GLOBAL__N__{h}_16_k_cu_helper) ;
\t\t..........
"""


def _listing(h, a="EXIT", b="EXIT"):
    return _LISTING.format(h=h, a=a, b=b)


def test_the_namespace_hash_is_zeroed_in_names_and_code():
    old = split_functions(_listing("d3915dea"))
    new = split_functions(_listing("1beedcab"))
    assert len(old) == 2 and old.keys() == new.keys()
    assert all("d3915dea" not in n and "d3915dea" not in c
               and "_ZN49_GLOBAL__N__00000000_16_k_cu" in n
               for n, c in old.items())
    assert compare(old, new) == [("same", n) for n in sorted(old)]


@pytest.mark.parametrize("a,b,states", [
    ("EXIT", "EXIT", ["same", "same"]),
    ("EXIT", "BRA 0x10", ["differs", "same"]),
    ("FFMA R2, R2, R3, R4", "EXIT", ["same", "differs"])],
    ids=["unchanged", "bf16-changed", "f32-changed"])
def test_each_kernel_is_same_or_differs(a, b, states):
    old = split_functions(_listing("d3915dea"))
    new = split_functions(_listing("1beedcab", a=a, b=b))
    got = dict((name, state) for state, name in compare(old, new))
    bf16 = [n for n in got if "bfloat16" in n]
    f32 = [n for n in got if "bfloat16" not in n]
    assert [got[bf16[0]], got[f32[0]]] == states


def test_a_kernel_one_build_lacks():
    old = split_functions(_listing("d3915dea"))
    new = dict(list(split_functions(_listing("1beedcab")).items())[:1])
    assert sorted(s for s, _ in compare(old, new)) == ["only in old", "same"]
    assert sorted(s for s, _ in compare(new, old)) == ["only in new", "same"]
