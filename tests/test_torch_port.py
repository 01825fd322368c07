"""The PyTorch port stands apart from the JAX package.

* Importing the port's pipelines, training, query layer and CLIs loads
  no JAX, Flax, optax, pandas or `cova_tpu` module (the GPU machine must
  not need JAX, and has no pandas).
* The host modules the port carries as copies (they are JAX-free, but
  their package's __init__ imports JAX) stay equal to their originals,
  after mapping `cova_tpu_torch` to `cova_tpu`, except for the listed
  regions.
* chip_smoke.py refuses to run without a CUDA device or outside a
  checkout, and then prints no result.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# Copied modules, and the region of each that may differ: (first line
# prefix, prefix of the first line after it), or None for a verbatim copy.
COPIES = {
    "config.py": None,
    # The docstring names the reference's config without a machine path.
    "utils/mp4loop.py": ("days of real camera footage", "multi-day datasets"),
    "scheduler/__init__.py": None,
    "scheduler/tracks.py": None,
    "scheduler/selector.py": None,
    "aggregator/__init__.py": None,
    "aggregator/associator.py": None,
    # The port builds its own library (no libavcodec, pixdec stub) from
    # the shared sources in cova_tpu/csrc: paths and the build differ.
    "codec/__init__.py": ("_DIR = ", "_lib = None"),
    "tracker/host.py": None,
    "models/bgdet.py": None,
    "pipeline/naive.py": None,
    # The docstring names the demo clip without a machine path.
    "query/datasets.py": ("The demo dataset is the", "(reference: parse/config.yaml"),
}


def _strip_region(text, region):
    if region is None:
        return text
    lines = text.splitlines(keepends=True)
    start = next(i for i, ln in enumerate(lines) if ln.startswith(region[0]))
    end = next(i for i, ln in enumerate(lines) if ln.startswith(region[1]))
    assert start < end
    return "".join(lines[:start] + ["<allowed region>\n"] + lines[end:])


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_matches_original(rel):
    port = (REPO / "cova_tpu_torch" / rel).read_text().replace("cova_tpu_torch", "cova_tpu")
    orig = (REPO / "cova_tpu" / rel).read_text()
    assert _strip_region(port, COPIES[rel]) == _strip_region(orig, COPIES[rel])


def _function_source(path, name):
    """Source of the top-level function or class `name` in `path`."""
    text = path.read_text()
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == name:
            return ast.get_source_segment(text, node)
    raise AssertionError(f"{name} not in {path}")


def test_unpack_outputs_np_matches_original():
    rel = pathlib.Path("pipeline") / "compressed.py"
    port = _function_source(REPO / "cova_tpu_torch" / rel, "unpack_outputs_np")
    orig = _function_source(REPO / "cova_tpu" / rel, "unpack_outputs_np")
    assert port == orig


# The lines a copied function may change: (port's text, original's text).
FUNCTION_CHANGES = {
    # The port makes the MOG2 labels on a torch device, the card by default.
    "build_training_set": [
        ('    log=print,\n    device="cuda",\n', "    log=print,\n"),
        ("generate_labels(luma, device=device)", "generate_labels(luma)"),
    ],
}


@pytest.mark.parametrize(
    "rel,name",
    [
        ("pipeline/compressed.py", "unpack_masks"),
        ("utils/dataset.py", "pack_metadata"),
        ("utils/dataset.py", "decode_luma_halfres"),
        ("utils/dataset.py", "_negate_mv_channel"),
        ("utils/dataset.py", "augment_training_set"),
        ("utils/dataset.py", "build_training_set"),
        ("utils/dataset.py", "ArrayDataset"),
    ],
)
def test_copied_function_matches_original(rel, name):
    port = _function_source(REPO / "cova_tpu_torch" / rel, name)
    orig = _function_source(REPO / "cova_tpu" / rel, name)
    for new, old in FUNCTION_CHANGES.get(name, []):
        assert port.count(new) == 1, new
        port = port.replace(new, old)
    assert port == orig


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import cova_tpu_torch.pipeline.cova, cova_tpu_torch.run_cova\n"
        "import cova_tpu_torch.ops.cuda.cc_kernel, cova_tpu_torch.ops.assignment\n"
        "import cova_tpu_torch.tracker.host, cova_tpu_torch.pipeline.sort_pipeline\n"
        "import cova_tpu_torch.models.yolov4, cova_tpu_torch.models.darknet_cfg\n"
        "import cova_tpu_torch.models.bgdet, cova_tpu_torch.pipeline.naive\n"
        "import cova_tpu_torch.ops.cuda.nms_kernel, cova_tpu_torch.utils.dataset\n"
        "import cova_tpu_torch.ops.cuda.mog2_kernel, cova_tpu_torch.utils.mog\n"
        "import cova_tpu_torch.models.losses, cova_tpu_torch.models.train_blobnet\n"
        "import cova_tpu_torch.examples.train_blobnet\n"
        "import cova_tpu_torch.examples.finetune_augment\n"
        "import cova_tpu_torch.query, cova_tpu_torch.examples.accuracy\n"
        "import cova_tpu_torch.examples.sweep_accuracy, cova_tpu_torch.examples.reproduce_synth\n"
        "import cova_tpu_torch.examples.run_experiment\n"
        "import cova_tpu_torch.examples.reproduce_accuracy\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'cova_tpu',\n"
        "                                    'pandas'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


# pandas too: the card's machine has none (the query layer reads CSVs
# with numpy).
JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "cova_tpu", "pandas")


def test_port_sources_do_not_name_jax():
    for path in sorted((REPO / "cova_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in JAX_NAMES, (path, n)


ENTRY_POINTS = [
    ("pipeline.cova", "CovaPipeline.__init__"),
    ("pipeline.cova", "CovaPipeline.multi"),
    ("pipeline.sort_pipeline", "SortPipeline.__init__"),
    ("models.yolov4", "make_yolo_detector"),
    ("models.yolov4", "create_yolov4"),
    ("models.darknet_cfg", "create_darknet"),
    ("models.blobnet", "load_artifact"),
    ("models.blobnet", "create_blobnet"),
    ("models.train_blobnet", "train_blobnet"),
    ("utils.mog", "generate_labels"),
    ("utils.dataset", "build_training_set"),
    ("examples.sweep_accuracy", "SweepContext.__init__"),
]


@pytest.mark.parametrize("module,name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(module, name):
    """The card is the default; the CPU is asked for (as these tests do)."""
    import importlib
    import inspect

    obj = importlib.import_module(f"cova_tpu_torch.{module}")
    for part in name.split("."):
        obj = getattr(obj, part)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


def test_run_cova_defaults_to_the_card():
    from cova_tpu_torch import run_cova

    assert run_cova.parser().parse_args(["in.mp4", "out"]).device == "cuda"
    assert run_cova.parser().parse_args(["in.mp4", "out", "--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("module,argv", [
    ("examples.train_blobnet", ["in.mp4", "ckpt"]),
    ("examples.finetune_augment", ["base.npz", "out.npz", "in.mp4"]),
    ("examples.sweep_accuracy", []),
    ("examples.reproduce_synth", ["--replay"]),
    ("examples.reproduce_accuracy", ["--input", "in.mp4"]),
    ("examples.run_experiment", ["exp.json"]),
])
def test_clis_default_to_the_card(module, argv):
    import importlib

    parser = importlib.import_module(f"cova_tpu_torch.{module}").parser()
    assert parser.parse_intermixed_args(argv).device == "cuda"
    assert parser.parse_intermixed_args(argv + ["--device", "cpu"]).device == "cpu"


def _smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120,
    )


def test_chip_smoke_needs_a_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run for real")
    res = _smoke(REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    res = _smoke(alone)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
