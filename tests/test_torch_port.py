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

# Copied modules, and the regions of each that may differ: (first line
# prefix, prefix of the first line after it), a list of such, or None for
# a verbatim copy.
COPIES = {
    "config.py": None,
    # The docstring names the reference's config without a machine path.
    "utils/mp4loop.py": ("days of real camera footage", "multi-day datasets"),
    "scheduler/__init__.py": None,
    "scheduler/tracks.py": None,
    "scheduler/selector.py": None,
    "aggregator/__init__.py": None,
    "aggregator/associator.py": None,
    # The port builds its own library (no libavcodec, pixdec stub, and the
    # syntax decoder of csrc/rec) from the shared sources in cova_tpu/csrc:
    # paths and the build differ. At the end, the port's own pixel decoder
    # (codec/pixrec.py) is bound to PixelDecoder.
    "codec/__init__.py": [("_DIR = ", "_lib = None"),
                          ("# The port's own pixel decoder", None)],
    "tracker/host.py": None,
    "models/bgdet.py": None,
    "pipeline/naive.py": None,
    # The docstring names the demo clip without a machine path.
    "query/datasets.py": ("The demo dataset is the", "(reference: parse/config.yaml"),
    # The PAFF generator: its docstring names the reference's README
    # without a machine path, and it imports the encoder from the port's
    # package instead of through sys.path.
    "tools/paff_gen.py": [("decodes any conforming stream", "field coding per ITU-T"),
                          ("import sys", "class BitWriter")],
    # The CABAC table headers are read from cova_tpu/csrc, where the
    # original module's directory lies.
    "tools/cabac_enc.py": ("_HERE = ", "def _parse_int_table"),
    # The reconstruction's syntax decoder: copies of the shared parameter
    # set parser and entropy decoder in namespace cova_rec, which keep
    # what pixel reconstruction needs. They differ only in marked lines.
    "csrc/rec/h264_params.h": "marked",
    "csrc/rec/h264_params.cc": "marked",
    "csrc/rec/entdec.h": "marked",
    "csrc/rec/entdec.cc": "marked",
}
# Copies whose original lies elsewhere under cova_tpu/.
ORIGINALS = {
    "tools/paff_gen.py": "csrc/tools/paff_gen.py",
    "tools/cabac_enc.py": "csrc/tools/cabac_enc.py",
    "csrc/rec/h264_params.h": "csrc/h264_params.h",
    "csrc/rec/h264_params.cc": "csrc/h264_params.cc",
    "csrc/rec/entdec.h": "csrc/entdec.h",
    "csrc/rec/entdec.cc": "csrc/entdec.cc",
}


def _strip_region(text, region):
    if region is None:
        return text
    if isinstance(region, list):
        for one in region:
            text = _strip_region(text, one)
        return text
    lines = text.splitlines(keepends=True)
    if region[1] is None:
        # A region the port appends at the end: dropped where present.
        starts = [i for i, ln in enumerate(lines) if ln.startswith(region[0])]
        return "".join(lines[:starts[0]]).rstrip("\n") + "\n" if starts else text
    start = next(i for i, ln in enumerate(lines) if ln.startswith(region[0]))
    end = next(i for i, ln in enumerate(lines) if ln.startswith(region[1]))
    assert start < end
    return "".join(lines[:start] + ["<allowed region>\n"] + lines[end:])


def _marked(lines):
    """Which lines are marked: inside a `// rec: begin` ... `// rec: end`
    block (markers included) or carrying a `// rec` tag."""
    import re

    out, inside = [], False
    for ln in lines:
        if "// rec: begin" in ln:
            inside = True
        out.append(inside or re.search(r"//\s*rec\b", ln) is not None)
        if "// rec: end" in ln:
            inside = False
    return out


def _unmarked_changes(port, orig):
    """The changes of a C++ copy (namespace cova_rec read as cova) that lie
    outside its marked lines: inserted or replaced lines unmarked, or
    original lines dropped where no marked line stands. Blank lines do not
    count."""
    import difflib

    a = orig.splitlines()
    b = port.replace("namespace cova_rec", "namespace cova").splitlines()
    marks = _marked(b)
    bad = []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        if j2 > j1:
            bad += [b[j] for j in range(j1, j2) if not marks[j]]
        elif not any(marks[j] for j in (j1 - 1, j1) if 0 <= j < len(b)):
            bad += [f"dropped: {ln}" for ln in a[i1:i2]]
    return [ln for ln in bad if ln.strip() and ln != "dropped: "]


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_matches_original(rel):
    port = (REPO / "cova_tpu_torch" / rel).read_text().replace("cova_tpu_torch", "cova_tpu")
    orig = (REPO / "cova_tpu" / ORIGINALS.get(rel, rel)).read_text()
    if COPIES[rel] == "marked":
        assert _unmarked_changes(port, orig) == []
        return
    assert _strip_region(port, COPIES[rel]) == _strip_region(orig, COPIES[rel])


def test_paff_generator_copy_writes_the_originals_stream(tmp_path):
    """The port's generator (smoke phases 4, 6, 8) writes the same bytes
    as the original, CAVLC and CABAC scenarios alike."""
    import importlib.util

    from cova_tpu_torch.tools import paff_gen

    spec = importlib.util.spec_from_file_location(
        "paff_gen_original", REPO / "cova_tpu" / "csrc" / "tools" / "paff_gen.py"
    )
    orig = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(orig)
    for name, args in (("scenario_pipeline", (16, 8, 24, 8)), ("scenario_cabac_b", ())):
        a, b = tmp_path / f"{name}_port.rec", tmp_path / f"{name}_orig.rec"
        getattr(paff_gen, name)(*args).write_rec(str(a))
        getattr(orig, name)(*args).write_rec(str(b))
        assert a.read_bytes() == b.read_bytes(), name


def test_chip_smoke_loads_no_module_by_path():
    """chip_smoke.py reaches the port only through imports from the
    checkout's root: no module executed by file path, no other directory
    put on sys.path."""
    text = (REPO / "chip_smoke.py").read_text()
    for node in ast.walk(ast.parse(text)):
        if not isinstance(node, ast.Call):
            continue
        name = ast.get_source_segment(text, node.func)
        assert not name.endswith(("spec_from_file_location", "exec_module", "run_path")), name
        if name in ("sys.path.insert", "sys.path.append"):
            assert ast.get_source_segment(text, node.args[-1]) == "str(REPO)", name


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
        "import cova_tpu_torch.parallel, cova_tpu_torch.graft_entry\n"
        "import cova_tpu_torch.examples.profile_device, cova_tpu_torch.examples.soak\n"
        "import cova_tpu_torch.tools.paff_gen\n"
        "import cova_tpu_torch.bench, cova_tpu_torch.examples.reproduce_1080p\n"
        "import cova_tpu_torch.examples.fig8\n"
        "import cova_tpu_torch.codec.pixrec, cova_tpu_torch.ops.cuda.h264_kernels\n"
        "import cova_tpu_torch.models.rtdetr, cova_tpu_torch.ops.cuda.msda_kernel\n"
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
    ("models.rtdetr", "make_rtdetr_detector"),
    ("models.darknet_cfg", "create_darknet"),
    ("models.blobnet", "load_artifact"),
    ("models.blobnet", "create_blobnet"),
    ("models.train_blobnet", "train_blobnet"),
    ("utils.mog", "generate_labels"),
    ("utils.dataset", "build_training_set"),
    ("examples.sweep_accuracy", "SweepContext.__init__"),
    ("examples.profile_device", "profile"),
    ("examples.soak", "soak"),
    ("graft_entry", "entry"),
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
    ("examples.profile_device", []),
    ("examples.soak", ["2", "out"]),
    ("graft_entry", []),
    ("bench", []),
    ("examples.reproduce_1080p", []),
    ("examples.fig8", []),
])
def test_clis_default_to_the_card(module, argv):
    import importlib

    parser = importlib.import_module(f"cova_tpu_torch.{module}").parser()
    assert parser.parse_intermixed_args(argv).device == "cuda"
    assert parser.parse_intermixed_args(argv + ["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("module", ["bench", "examples.reproduce_1080p", "examples.fig8"])
def test_clis_raise_without_a_card(module, tmp_path):
    """With the default device and no card, they raise before any work."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = importlib.import_module(f"cova_tpu_torch.{module}").main
    argv = {"bench": [], "examples.reproduce_1080p": [str(tmp_path / "out")],
            "examples.fig8": ["--work", str(tmp_path / "out"),
                              "--out", str(tmp_path / "out" / "fig8.json")]}[module]
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        main(argv)
    assert not (tmp_path / "out").exists()


def test_multi_device_entry_points_default_to_the_card():
    import inspect

    from cova_tpu_torch.graft_entry import dryrun_multichip
    from cova_tpu_torch.parallel.mesh import make_mesh

    for fn in (dryrun_multichip, make_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda"


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
