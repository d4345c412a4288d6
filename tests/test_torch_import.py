"""The torch port imports without JAX: every module loads in a process where
`jax`, `jaxlib`, `flax`, `optax` and `orbax` cannot be imported (a subprocess,
because this test process already imported jax, tests/conftest.py), and no
source of the port or `chip_smoke.py` imports the JAX package, not even
inside a function."""

import ast
import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import diffusion_e2e_ft_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run first in a process, it makes JAX and its libraries unimportable
JAX_BLOCKER = (
    "import sys\n"
    "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'):\n"
    "    sys.modules[name] = None\n"
)


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(
            diffusion_e2e_ft_tpu_torch.__path__, prefix="diffusion_e2e_ft_tpu_torch."
        )
    )


def test_port_modules_listed():
    mods = _port_modules()
    for expected in (
        "diffusion_e2e_ft_tpu_torch.kernels.flash_attention",
        "diffusion_e2e_ft_tpu_torch.kernels.gn_conv",
        "diffusion_e2e_ft_tpu_torch.kernels.groupnorm",
        "diffusion_e2e_ft_tpu_torch.pipelines.loading",
        "diffusion_e2e_ft_tpu_torch.cli.serve",
        "diffusion_e2e_ft_tpu_torch.cli.train",
        "diffusion_e2e_ft_tpu_torch.data.mixer",
        "diffusion_e2e_ft_tpu_torch.data.train_datasets",
        "diffusion_e2e_ft_tpu_torch.pipelines.geowizard",
        "diffusion_e2e_ft_tpu_torch.ops.losses",
        "diffusion_e2e_ft_tpu_torch.training.checkpoints",
        "diffusion_e2e_ft_tpu_torch.training.config",
        "diffusion_e2e_ft_tpu_torch.training.geowizard",
        "diffusion_e2e_ft_tpu_torch.ops.noise",
        "diffusion_e2e_ft_tpu_torch.ops.ensemble",
        "diffusion_e2e_ft_tpu_torch.training.loop",
        "diffusion_e2e_ft_tpu_torch.training.lr",
        "diffusion_e2e_ft_tpu_torch.training.optim",
        "diffusion_e2e_ft_tpu_torch.training.trainer",
        "diffusion_e2e_ft_tpu_torch.utils.logging",
        "diffusion_e2e_ft_tpu_torch.utils.seeding",
        "diffusion_e2e_ft_tpu_torch.native_io",
        "diffusion_e2e_ft_tpu_torch.data.image_io",
        "diffusion_e2e_ft_tpu_torch.data.splits",
        "diffusion_e2e_ft_tpu_torch.data.depth_eval",
        "diffusion_e2e_ft_tpu_torch.data.normal_eval",
        "diffusion_e2e_ft_tpu_torch.evaluation.metrics",
        "diffusion_e2e_ft_tpu_torch.evaluation.alignment",
        "diffusion_e2e_ft_tpu_torch.evaluation.depth_bench",
        "diffusion_e2e_ft_tpu_torch.evaluation.normal_bench",
        "diffusion_e2e_ft_tpu_torch.cli.common",
        "diffusion_e2e_ft_tpu_torch.cli.infer",
        "diffusion_e2e_ft_tpu_torch.cli.eval_depth",
        "diffusion_e2e_ft_tpu_torch.cli.eval_normals",
        "diffusion_e2e_ft_tpu_torch.cli.run_marigold",
        "diffusion_e2e_ft_tpu_torch.cli.run_geowizard",
        "diffusion_e2e_ft_tpu_torch.utils.geometry",
        "diffusion_e2e_ft_tpu_torch.ops.depth_transform",
        "diffusion_e2e_ft_tpu_torch.training.normal_losses",
        "diffusion_e2e_ft_tpu_torch.data.augmentations",
        "diffusion_e2e_ft_tpu_torch.tools",
        "diffusion_e2e_ft_tpu_torch.tools.depth_to_normal",
        "diffusion_e2e_ft_tpu_torch.tools.hypersim_preprocess",
        "diffusion_e2e_ft_tpu_torch.tools.make_splits",
        "diffusion_e2e_ft_tpu_torch.cli.gen_vkitti_normals",
        "diffusion_e2e_ft_tpu_torch.cli.preprocess_hypersim",
        "diffusion_e2e_ft_tpu_torch.parallel",
        "diffusion_e2e_ft_tpu_torch.parallel.mesh",
        "diffusion_e2e_ft_tpu_torch.parallel.sharding",
    ):
        assert expected in mods


def test_imports_with_jax_blocked():
    code = (
        JAX_BLOCKER
        + "import importlib\n"
        f"for mod in {_port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "assert not any(m == 'diffusion_e2e_ft_tpu' or m.startswith('diffusion_e2e_ft_tpu.')\n"
        "               for m in sys.modules), 'the port imported the JAX package'\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_train_cli_data_readers_import_without_jax():
    """`cli.train`'s data readers and mixer are the port's own copies; they
    (and the CLI's parser) load with JAX blocked too."""
    code = (
        JAX_BLOCKER
        + "from diffusion_e2e_ft_tpu_torch.data.mixer import BatchLoader, MixedLoader, Prefetcher\n"
        "from diffusion_e2e_ft_tpu_torch.data.train_datasets import Hypersim, VirtualKITTI2\n"
        "from diffusion_e2e_ft_tpu_torch.cli.train import build_parser\n"
        "build_parser().parse_args(['--pretrained_model_name_or_path', 'x'])\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _jax_package_imports(path: pathlib.Path) -> list:
    """Every `import diffusion_e2e_ft_tpu...` / `from diffusion_e2e_ft_tpu... import`
    in a source, at any depth, as (line, module)."""
    return _imports(path, ("diffusion_e2e_ft_tpu",))


# the golden outputs' rule, the port's runners and their tests, which a box without JAX runs
GOLDEN_SOURCES = ["tests/_torch_golden.py", "tests/_torch_golden_port.py", "tests/test_torch_golden.py"]


def test_no_source_imports_the_jax_package():
    root = pathlib.Path(REPO)
    sources = (sorted((root / "diffusion_e2e_ft_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
               + [root / p for p in GOLDEN_SOURCES])
    assert len(sources) > 30
    offending = {str(p.relative_to(root)): hits for p in sources if (hits := _jax_package_imports(p))}
    assert offending == {}


def _imports(path: pathlib.Path, roots) -> list:
    """Every import of a module under one of `roots`, at any depth, as (line, module)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] in roots]
    return found


def test_golden_sources_import_no_jax():
    """The goldens' rule, runners and tests import no JAX library; the
    generator (which runs the JAX package) imports nothing of the port."""
    root = pathlib.Path(REPO)
    jax_libraries = ("jax", "jaxlib", "flax", "optax", "orbax")
    assert {p: _imports(root / p, jax_libraries) for p in GOLDEN_SOURCES} == dict.fromkeys(GOLDEN_SOURCES, [])
    generator = root / "tests" / "golden" / "make_goldens.py"
    assert _imports(generator, ("diffusion_e2e_ft_tpu_torch",)) == [] and _imports(generator, ("jax",))


def test_experiment_twins_invoke_port_modules():
    """Every `python -m` of `experiments_torch/` names a module of the port
    (which `test_imports_with_jax_blocked` imports with JAX blocked)."""
    invoked = set()
    for path in pathlib.Path(REPO, "experiments_torch").rglob("*.sh"):
        invoked |= set(re.findall(r"python -m (\S+)", path.read_text()))
    assert invoked == {"diffusion_e2e_ft_tpu_torch.cli.infer", "diffusion_e2e_ft_tpu_torch.cli.eval_depth",
                       "diffusion_e2e_ft_tpu_torch.cli.eval_normals"}
    assert invoked <= set(_port_modules())


def test_import_scan_sees_nested_imports(tmp_path):
    """The scan finds the JAX package's imports inside functions, and only those."""
    src = tmp_path / "probe.py"
    src.write_text(
        "import diffusion_e2e_ft_tpu_torch\n"
        "from diffusion_e2e_ft_tpu_torch.kernels import attention\n"
        "def main():\n"
        "    from diffusion_e2e_ft_tpu.data.mixer import BatchLoader\n"
        "    import diffusion_e2e_ft_tpu.ops.image as im\n"
        "    from . import sibling\n"
    )
    assert _jax_package_imports(src) == [(4, "diffusion_e2e_ft_tpu.data.mixer"), (5, "diffusion_e2e_ft_tpu.ops.image")]
