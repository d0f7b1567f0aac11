"""The port's configuration against the reference's: every preset and a
YAML load give the same fields, and no module of the port (nor
``chip_smoke.py``) imports, reads or executes anything of ``mfm_tpu``.
"""

import dataclasses
import re
from pathlib import Path

import pytest

import mfm_tpu.config as jcfg
import mfm_tpu_torch.config as pcfg

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("4-mode", "gaussian-mixture", "phi-four", "pines", "funnel", "many-well")


@pytest.mark.parametrize("example", EXAMPLES)
def test_preset_matches_reference(example):
    assert dataclasses.asdict(pcfg.preset(example)) == dataclasses.asdict(jcfg.preset(example))


def test_from_yaml_matches_reference(tmp_path):
    (tmp_path / "base.yaml").write_text("ode_steps: 12\nhidden_x: [32, 16]\n")
    (tmp_path / "run.yaml").write_text(
        "include: base.yaml\nexample: phi-four\nnum_chain: 256\nfield_precision: highest\n"
    )
    path = str(tmp_path / "run.yaml")
    got = pcfg.from_yaml(path, seed=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg.from_yaml(path, seed=3))
    assert (got.ode_steps, got.hidden_x, got.num_chain, got.seed) == (12, (32, 16), 256, 3)
    with pytest.raises(ValueError, match="unknown config field"):
        pcfg.preset("4-mode", no_such_field=1)


# An import of the reference package, a path component "mfm_tpu", a quoted
# path to one of its .py files (a "file.py:line" citation is not a read),
# or exec of any source.
_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+mfm_tpu(\.|\s|$)", re.M),
    re.compile(r"""["']mfm_tpu["']"""),
    re.compile(r"""["']mfm_tpu/[^"':]*["']"""),
    re.compile(r"""import_module\(\s*["']mfm_tpu[."']"""),
    re.compile(r"\bexec\("),
]


def test_port_reads_nothing_of_the_reference():
    files = sorted((ROOT / "mfm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    hits = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for pat in _FORBIDDEN
        for m in pat.finditer(f.read_text())
    ]
    assert not hits, hits
    # the scan does catch what the port once did
    assert any(p.search('exec(compile((root / "mfm_tpu" / "config.py").read_text()))')
               for p in _FORBIDDEN)
