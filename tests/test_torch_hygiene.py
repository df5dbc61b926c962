"""The PyTorch port stands alone: no module of ``milnce_tpu_torch/`` and
not ``chip_smoke.py`` imports jax, flax, optax or the JAX package, read
from the source (AST) and checked by importing every module in a fresh
interpreter where those imports fail."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "milnce_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "milnce_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_package_exists():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for expected in ("config.py", "models/s3dg.py", "ops/milnce_stream.py",
                     "ops/softdtw.py", "ops/softdtw_cuda.py",
                     "losses/milnce_chunked.py", "losses/dtw_losses.py",
                     "train/step.py", "train/cli.py", "train/checkpoint.py",
                     "train/loop.py", "data/tokenizer.py",
                     "data/captions.py", "data/video.py", "data/datasets.py",
                     "data/manifest.py", "data/pipeline.py",
                     "data/synthetic.py", "eval/metrics.py",
                     "eval/retrieval.py", "eval/linear_probe.py",
                     "eval/runner.py", "eval/cli.py",
                     "utils/torch_convert.py", "utils/logging.py",
                     "utils/profiling.py", "utils/roofline.py",
                     "parallel/dist.py", "obs/__init__.py", "obs/runctx.py",
                     "obs/metrics.py", "obs/spans.py", "obs/export.py",
                     "obs/goodput.py", "obs/aggregate.py", "obs/anomaly.py",
                     "obs/capture.py", "resilience/faults.py",
                     "ops/dtw.py", "train/curriculum.py",
                     "elastic/__init__.py", "elastic/drain.py",
                     "elastic/stamp.py", "elastic/straggler.py",
                     "native/__init__.py", "native/build.py",
                     "native/reader.py", "native/softdtw_cpu.py",
                     "native/bench_reader.py", "parallel/mesh.py",
                     "parallel/sharding_map.py", "ops/softdtw_sp.py",
                     "analysis/__init__.py", "analysis/lockrt.py",
                     "analysis/rules.py", "analysis/astlint.py",
                     "analysis/concurrency.py", "analysis/optrace.py",
                     "analysis/trace_invariants.py", "analysis/memplan.py",
                     "analysis/numerics.py", "analysis/report.py",
                     "analysis/__main__.py", "utils/timing.py",
                     "serving/__init__.py", "serving/export.py",
                     "serving/cache.py", "serving/batcher.py",
                     "serving/engine.py", "serving/index.py",
                     "serving/live_index.py", "serving/pool.py",
                     "serving/service.py", "quant/__init__.py",
                     "quant/quantize.py", "quant/calibrate.py",
                     "quant/distill.py", "utils/assets.py"):
        assert expected in names
    assert (PORT / "csrc" / "milnce_stream.cu").exists()
    assert (PORT / "csrc" / "softdtw.cu").exists()
    assert (PORT / "csrc" / "milnce_native.cpp").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_forbidden_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    modules = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        modules.append(".".join(parts[:-1] if parts[-1] == "__init__"
                                else parts))
    code = "\n".join(
        ["import sys"]
        + [f"sys.modules[{name!r}] = None" for name in FORBIDDEN]
        + ["import importlib, runpy"]
        + [f"importlib.import_module({m!r})" for m in modules]
        # chip_smoke must import too (its main() is not run)
        + [f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, "
           "run_name='chip_smoke_import_check')",
           "bad = [m for m in sys.modules if m.split('.')[0] in "
           f"{FORBIDDEN!r} and sys.modules[m] is not None]",
           "assert not bad, bad",
           "print('ok', len(sys.modules))"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _code_strings(path: pathlib.Path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_package_path_is_read_at_run_time(path):
    """No code string of the port names a file of the JAX package or its
    native build (``native/milnce_native.cpp``, ``build/libmilnce_native.so``):
    the port reads its own copies."""
    bad = [s for s in _code_strings(path)
           if "milnce_tpu/" in s or "libmilnce_native.so" in s
           or s.startswith("native/")]
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def test_native_library_builds_from_the_ports_own_source():
    """The host library compiles from ``milnce_tpu_torch/csrc/
    milnce_native.cpp`` into ``build/torch_kernels/`` and loads from
    there; the copied source includes no file of the repository."""
    from milnce_tpu_torch.native import build

    assert build.SOURCE == PORT / "csrc" / "milnce_native.cpp"
    assert build.library_path().parent == ROOT / "build" / "torch_kernels"
    includes = [line for line in build.SOURCE.read_text().splitlines()
                if line.startswith("#include")]
    assert includes and all("<" in line for line in includes)
    if build.native_available():
        assert build.load_native_library()._name == str(build.library_path())


def _package_data_patterns():
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as fh:
        project = tomllib.load(fh)
    return project["tool"]["setuptools"]["package-data"]["milnce_tpu_torch"]


def test_package_data_ships_every_native_source():
    """Every file under ``milnce_tpu_torch/csrc/`` matches a package-data
    pattern of ``pyproject.toml``, so that an installed port can build
    each of its libraries (the CUDA kernels and the host C++ library)."""
    import fnmatch

    patterns = _package_data_patterns()
    files = sorted(p.relative_to(PORT).as_posix()
                   for p in (PORT / "csrc").rglob("*") if p.is_file())
    assert files
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f, pat) for pat in patterns)]
    assert not missing, f"not in the package data {patterns}: {missing}"


def test_console_scripts_of_the_port():
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    for name in ("train", "eval", "export", "assets", "serve", "manifest"):
        target = scripts[f"milnce-{name}-torch"]
        assert target.startswith("milnce_tpu_torch.")
        module, _, func = target.partition(":")
        assert (ROOT / (module.replace(".", "/") + ".py")).is_file()
        assert func == "main"


def test_build_dir_outside_a_checkout_is_the_user_cache(tmp_path):
    """A copy of the package outside a checkout (as installed into
    ``site-packages``) builds into ``$XDG_CACHE_HOME/milnce_tpu_torch``,
    or ``~/.cache/milnce_tpu_torch`` without it, never under itself; in
    the checkout it keeps ``build/torch_kernels``."""
    import shutil

    from milnce_tpu_torch.ops import cuda_build

    assert cuda_build.BUILD_DIR == ROOT / "build" / "torch_kernels"
    site = tmp_path / "site-packages"
    shutil.copytree(PORT, site / "milnce_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from milnce_tpu_torch.ops import cuda_build; "
            "from milnce_tpu_torch.native import build; "
            "print(cuda_build.BUILD_DIR); print(build.library_path().parent)")
    for env_cache, want in ((str(tmp_path / "xdg"),
                             tmp_path / "xdg" / "milnce_tpu_torch"),
                            (None, tmp_path / "home" / ".cache"
                             / "milnce_tpu_torch")):
        env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path / "home"),
               "PYTHONPATH": str(site)}
        if env_cache is not None:
            env["XDG_CACHE_HOME"] = env_cache
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == [str(want), str(want)]
        assert not str(want).startswith(str(site))
