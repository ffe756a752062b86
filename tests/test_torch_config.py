"""The PyTorch package's config and import hygiene.

Its RenderConfig must not drift from the JAX package's (one config
describes a render in either package): the same fields, the same defaults
but the coarse phase's (``coarse_precision``, ``coarse_eps``), which the
port sets from the H100's chain errors. The package must never import
JAX: not at import time, and not while it renders.
"""
import ast
import dataclasses
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

from cudaneuralrender_torch.utils.config import RenderConfig as TorchConfig  # noqa: E402
from cudaneuralrender_tpu.utils.config import RenderConfig as JaxConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "cudaneuralrender_torch")


# The mixed march's coarse phase, which each package sets from its own
# device's chain errors (the port's: utils/config.py, from the H100's).
LADDER = ("coarse_precision", "coarse_eps")


def test_render_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TorchConfig)]
    assert [name for name, _ in tf] == [name for name, _ in jf]
    assert [x for x in tf if x[0] not in LADDER] == [x for x in jf if x[0] not in LADDER]
    ladder = {name: getattr(TorchConfig(), name) for name in LADDER}
    assert repr(TorchConfig()) == repr(JaxConfig(**ladder))
    # the ladder's fields take the same values in both packages
    assert repr(TorchConfig(**{name: getattr(JaxConfig(), name) for name in LADDER})) == \
        repr(JaxConfig())


def test_render_config_validation_matches():
    for kw in ({"scene": "nope"}, {"num_inputs": 5}, {"march_impl": "x"},
               {"refine_caps": (1,)}, {"cyl_window": 4}):
        for cls in (JaxConfig, TorchConfig):
            try:
                cls(**kw).validate()
            except ValueError:
                continue
            raise AssertionError(f"{cls.__module__} accepted {kw}")


def test_package_never_imports_jax():
    """Import the package and render a 16x16 staged frame on the CPU in a
    fresh interpreter; no jax module may appear in sys.modules."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import cudaneuralrender_torch as cnr\n"
        "p = cnr.load('examples/assets/csg_demo.h5', device='cpu')\n"
        "cfg = cnr.RenderConfig(width=16, height=16, march_impl='staged', max_steps=300)\n"
        "img = cnr.Renderer(p, cfg).render(cnr.Camera(rotation_y=30.0))\n"
        "assert img.shape == (16, 16, 4)\n"
        "added = [m for m in set(sys.modules) - before if m == 'jax' or m.startswith(('jax.', 'jaxlib'))]\n"
        "print('JAX_MODULES', sorted(added))\n"
    )
    env = dict(os.environ, CNR_SCHEDULE_MEMO="")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "JAX_MODULES []" in r.stdout, r.stdout


def test_package_source_has_no_jax_import():
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                else:
                    continue
                for m in mods:
                    if m.split(".")[0] in ("jax", "jaxlib", "cudaneuralrender_tpu"):
                        offenders.append(f"{path}: {m}")
    assert not offenders, offenders
