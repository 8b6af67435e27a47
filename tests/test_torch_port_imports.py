"""Every port module, and chip_smoke.py, imports where jax, flax, orbax,
cv2, sklearn, matplotlib, tensorboard and the JAX package itself are absent
(a PyTorch-only machine); and no source of the port names jax or the JAX
package in an import at any depth (inside a function too)."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SOURCES = sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "vfd_gan_tpu_torch", "**", "*.py"),
        recursive=True)) + ["chip_smoke.py"]
# never imported by the port, not even inside a function
NEVER = {"vfd_gan_tpu", "jax", "jaxlib", "flax", "orbax"}

_GUARDED_IMPORT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys
    BLOCKED = {"jax", "jaxlib", "flax", "orbax", "cv2", "sklearn",
               "matplotlib", "tensorboard", "tensorflow", "vfd_gan_tpu"}
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"forbidden import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import vfd_gan_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        vfd_gan_tpu_torch.__path__, "vfd_gan_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    print(" ".join(names))
""")


def test_port_imports_without_jax_or_cv2():
    res = subprocess.run([sys.executable, "-c", _GUARDED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert {f"vfd_gan_tpu_torch.{m}" for m in (
        "config", "ops.convs", "ops.resize", "ops.image", "ops.morphology", "ops.cuda",
        "ops.augment", "ops.losses", "ops.corr", "ops.warp",
        "ops.flow_refine", "ops.flow_fused", "ops.flow",
        "models.layers", "models.mygan", "utils.init", "utils.weights",
        "utils.checkpoint", "utils.runtime", "cli.infer", "cli.serve",
        "cli.trainer", "eval.metrics", "data.device_synthetic",
        "train.state", "train.checkpoints", "train.engine_base",
        "train.gan_engine", "ops.spatial_conv", "models.convlstm",
        "models.stcnn", "models.xception3d", "train.supervised_engine",
        "data.video_io", "data.native", "data.dataset", "data.synthetic",
        "parallel.prefetch", "obs.summary", "obs.profiling",
        "cli.evaluate_models", "cli.export_torch", "cli.frames",
        "train.host_flow", "parallel.mesh", "parallel.temporal",
        "parallel.sp_generator", "tools.dp_equivalence",
    )} <= names


def _imported_roots(tree: ast.AST):
    """(line, top-level package) of every import in ``tree``: ``import``
    and ``from`` statements at any depth, and ``import_module`` /
    ``__import__`` calls on a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(
                    arg, ast.Constant) and isinstance(arg.value, str):
                yield node.lineno, arg.value.split(".")[0]


def test_the_scan_sees_imports_inside_functions():
    tree = ast.parse(textwrap.dedent("""
        import os
        def f():
            from vfd_gan_tpu.data.video_io import read_clip
            import jax.numpy as jnp
            importlib.import_module("flax.linen")
    """))
    assert [r for _, r in _imported_roots(tree)] == [
        "os", "vfd_gan_tpu", "jax", "flax"]


@pytest.mark.parametrize("source", PORT_SOURCES)
def test_source_imports_nothing_of_jax_at_any_depth(source):
    with open(os.path.join(ROOT, source)) as f:
        tree = ast.parse(f.read(), filename=source)
    bad = [(line, root) for line, root in _imported_roots(tree)
           if root in NEVER]
    assert not bad, f"{source} imports {bad}"


def test_the_scan_covers_the_port():
    assert "chip_smoke.py" in PORT_SOURCES
    for rel in ("cli/infer.py", "cli/serve.py", "data/video_io.py",
                "ops/spatial_conv.py", "ops/cuda/__init__.py",
                "data/dataset.py", "data/native.py", "data/synthetic.py",
                "parallel/prefetch.py", "obs/summary.py",
                "obs/profiling.py"):
        assert os.path.join("vfd_gan_tpu_torch", rel) in PORT_SOURCES
