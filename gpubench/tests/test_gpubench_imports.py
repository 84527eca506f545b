"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(top-level names compared whole, so the port's own name passes), and the
reference loads nothing of the port."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "sequence_alignment_tools_tpu"}

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    __import__(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(mods):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), mods=mods)],
        capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def modules(*folders):
    """Every module of the harness's ``folders``, by its dotted name."""
    return [".".join(("gpubench",) + p.relative_to(ROOT / "gpubench")
                     .with_suffix("").parts).removesuffix(".__init__")
            for f in folders for p in (ROOT / "gpubench" / f).glob("*.py")]


def test_harness_import_graph_is_jax_free():
    mods = ["gpubench.harness", "gpubench.control", "gpubench.trace",
            "sequence_alignment_tools_tpu_torch.models.primer_match",
            "sequence_alignment_tools_tpu_torch.io.translate",
            "sequence_alignment_tools_tpu_torch.ops.conv_scan",
            "sequence_alignment_tools_tpu_torch.ops.sellers"]
    mods += modules("metrics", "databases", "mixes", "entries", "reference")
    top = loaded(mods)
    assert "sequence_alignment_tools_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    top = loaded(modules("reference"))
    assert "sequence_alignment_tools_tpu_torch" not in top
    assert not top & FORBIDDEN
    for src in (ROOT / "gpubench" / "reference").glob("*.py"):
        text = src.read_text()
        assert "sequence_alignment_tools_tpu" not in text
        assert "import jax" not in text


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from gpubench import harness

    monkeypatch.setitem(sys.modules, "sequence_alignment_tools_tpu_torch_x",
                        sys)
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()
