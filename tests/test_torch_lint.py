"""The port's `cli lint` (tools/graftlint over the port's own files) against
the JAX `cli lint`'s exit contract: 0 clean, 1 findings, 2 usage. The files
linted here lie outside the scan set, so each gets a single-file graph: no
test runs the whole-tree scan, whose 10 s budget this sandbox already
misses (ROADMAP "Not faults").
"""

import json
from pathlib import Path

import pytest

from k8s_llm_scheduler_tpu_torch import cli

REPO = Path(__file__).resolve().parent.parent
FINDING = '''def f(g):
    try:
        g()
    except Exception:
        pass
'''
CLEAN = '''def f(g):
    return g()
'''


def _lint(capsys, *argv):
    rc = cli.main(["lint", *argv])
    return rc, capsys.readouterr()


def test_a_finding_exits_1_and_a_clean_file_0(tmp_path, capsys):
    bad, good = tmp_path / "bad.py", tmp_path / "good.py"
    bad.write_text(FINDING)
    good.write_text(CLEAN)
    rc, out = _lint(capsys, "--no-cache", str(bad))
    assert rc == 1 and "swallowed-exception" in out.err
    rc, out = _lint(capsys, "--no-cache", "--format", "jsonl", str(bad))
    assert rc == 1 and json.loads(out.out.splitlines()[0])["rule"] == "swallowed-exception"
    rc, out = _lint(capsys, "--no-cache", str(good))
    assert rc == 0 and "graftlint: OK (1 files" in out.out
    rc, out = _lint(capsys, "--no-cache", "--rules", "py310", str(bad))
    assert rc == 0


def test_usage_errors_exit_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["lint", "--bogus"])
    assert exc.value.code == 2
    rc, out = _lint(capsys, str(tmp_path / "missing.py"))
    assert rc == 2 and "no such file" in out.err
    rc, out = _lint(capsys, "--rules", "no-such-rule", str(tmp_path))
    assert rc == 2
    rc, out = _lint(capsys, "--changed", "HEAD", str(tmp_path / "x.py"))
    assert rc == 2 and "mutually exclusive" in out.err


def test_list_rules_prints_the_catalog(capsys):
    rc, out = _lint(capsys, "--list-rules")
    assert rc == 0
    families = [line[:-1] for line in out.out.splitlines() if line and not line[0].isspace()]
    assert {"concurrency", "determinism", "py310"} <= set(families)
    assert "swallowed-exception" in out.out


def test_with_no_paths_it_lints_the_ports_own_files(monkeypatch):
    """With no paths the command hands graftlint the port's package,
    tests/test_torch_*.py, tools/torch_*.py and chip_smoke.py, by path, and
    nothing of the JAX package (graftlint itself is not run here)."""
    monkeypatch.syspath_prepend(str(REPO))
    from tools.graftlint import __main__ as graftlint

    seen = []
    monkeypatch.setattr(graftlint, "main", lambda argv: seen.append(argv) or 0)
    assert cli.main(["lint"]) == 0
    (argv,) = seen
    paths = [Path(a) for a in argv if a.endswith(".py")]
    assert argv[:2] == ["--format", "human"]
    rel = {str(p.relative_to(REPO)) for p in paths}
    assert "k8s_llm_scheduler_tpu_torch/engine/engine.py" in rel
    assert "chip_smoke.py" in rel
    assert any(r.startswith("tests/test_torch_") for r in rel)
    assert any(r.startswith("tools/torch_") for r in rel)
    assert not any(r.startswith(("k8s_llm_scheduler_tpu/", "tests/test_sharded")) for r in rel)
    assert not any("_build" in p.parts for p in paths)
    assert [Path(p) for p in cli.port_lint_files(REPO)] == paths
