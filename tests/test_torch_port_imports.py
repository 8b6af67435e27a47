"""Every port module, and chip_smoke.py, imports where jax, flax, orbax,
cv2, sklearn, matplotlib and the JAX package itself are absent (a
PyTorch-only machine)."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARDED_IMPORT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys
    BLOCKED = {"jax", "jaxlib", "flax", "orbax", "cv2", "sklearn",
               "matplotlib", "vfd_gan_tpu"}
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
    )} <= names
