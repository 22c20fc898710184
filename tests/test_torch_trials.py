"""The design-trial tools' shared harness (``tools/trials.py``) on the CPU,
and every textual variant of the trial scripts still applying to the
current kernel sources (a variant whose old text has drifted would stop
the script on the card)."""
import importlib.util
from pathlib import Path

import pytest

from tools import trials

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19tsmm_dmmaEPKd' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19tsmm_dmmaEPKd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 230 registers, used 1 barriers, 128 bytes smem
ptxas info    : Function properties for _ZN12_GLOBAL__N_116block_diag_tiledIddEEvPKT_
    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 20992 bytes smem
"""


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_apply_replaces_and_refuses_missing_text():
    assert trials.apply("a b a", [("a", "c"), ("b", "d")], "t") == "c d c"
    with pytest.raises(SystemExit, match="'x' not in the source"):
        trials.apply("a", [("x", "y")], "t")


def test_functions_and_report_read_a_ptxas_log(capsys):
    found = trials.functions(PTXAS)
    assert [f[2] for f in found] == ["Used 230 registers", "Used 80 registers"]
    assert "24 bytes spill stores" in found[1][1]
    trials.report("v", PTXAS, r"(tsmm_dmma|block_diag_tiled)(?:I(\w+?)E+v)?",
                  lambda m: m.group(1) + (f"<{m.group(2)}>" if m.group(2)
                                          else ""))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[ptxas] v tsmm_dmma: Used 230 registers; 0 b")
    assert out[1].startswith("[ptxas] v block_diag_tiled<dd>: Used 80")


def test_in_turns_reverses_every_other_round():
    order = []
    times = trials.in_turns({"a": "a", "b": "b"}, 3,
                            lambda key, **kw: order.append(key) or kw["x"],
                            x=1.5)
    assert order == ["a", "b", "b", "a", "a", "b"]
    assert times == {"a": [1.5] * 3, "b": [1.5] * 3}
    assert trials.times_text([2.0, 1.25]) == "2.0000 / 1.2500 ms, best 1.2500"


def test_through_swaps_the_entry_for_the_call_only():
    class Module:
        _entry = staticmethod(lambda: "built")
    seen = trials.through(Module, "variant", lambda: Module._entry())()
    assert seen == "variant" and Module._entry() == "built"


#: the source each single-source tool's VARIANTS change
SINGLE = {"b2_trials": "tsmttsm", "eig_trials": "herm_eig",
          "b6_trials": "mamba_scan"}


@pytest.mark.parametrize("tool", ["b2_trials", "b34_trials", "eig_trials",
                                  "b6_trials"])
def test_every_variant_applies_to_the_current_sources(tool):
    module = _tool(tool)
    for name, reps in module.VARIANTS.items():
        per_source = reps if isinstance(reps, dict) else {SINGLE[tool]: reps}
        for source, pairs in per_source.items():
            trials.apply((CSRC / f"{source}.cu").read_text(), pairs,
                         f"{tool} {name}")
