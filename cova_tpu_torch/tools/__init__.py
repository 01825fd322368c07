"""Stream generators the port's smoke and tests run (copies of
cova_tpu/csrc/tools/paff_gen.py and cabac_enc.py; the C++ sources and
CABAC table headers they read stay shared in cova_tpu/csrc)."""
