"""The port's copies of the reference's jax-free modules stay copies.

`repro_torch` imports nothing of `repro`, so it keeps its own copy of each
numpy scheduler module it runs (`core/` but `decision_torch.py`,
`core/workloads/`, `core/policies/`, `service/`, `faults/`, `campaign/`,
`runtime/cluster.py`, `runtime/straggler.py`, `launch/cluster.py`).  Each
copy is parsed with `ast` beside its reference file; docstrings are
stripped (comments never reach the tree) and the package name
`repro_torch` reads as `repro`, in imports and in string constants (a
CLI's `prog`, a message naming a command).  The two trees must then dump
equal.

Only what differs on purpose is exempt, in EXEMPT below, each with its
reason; the rest of an exempt file is still compared.  (`core/__init__.py`
differs from its reference in its docstring alone, so it needs no
exemption.)
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT, REF = SRC / "repro_torch", SRC / "repro"

COPIED = sorted(
    [p.relative_to(PORT).as_posix()
     for d in ("core", "service", "faults", "campaign") for p in (PORT / d).rglob("*.py")
     if p.name != "decision_torch.py"]
    + ["runtime/cluster.py", "runtime/straggler.py", "launch/cluster.py"])

#: path -> (reason, members dropped from both trees, {old: new} read into
#: the port's string constants before comparing)
EXEMPT = {
    "core/experiment.py": (
        "the decision sweep replays on torch: `device` takes 'torch' where the "
        "reference takes 'jax', the field `sweep_device` names the torch device, "
        "and `run` checks that device and passes it to `decision_torch`",
        ("Experiment.sweep_device", "Experiment.run"), {"torch": "jax"}),
    "campaign/spec.py": (
        "`default_output_dir` is results/torch/campaigns/<name>, so the port "
        "never writes over the reference's checked-in results/campaigns/",
        ("default_output_dir",), {}),
    "campaign/__main__.py": (
        "the `run --out` help names default_output_dir's value (campaign/spec.py)",
        (), {"results/torch/campaigns": "results/campaigns"}),
}


def _strip(tree: ast.AST, drop, strings, port: bool) -> ast.AST:
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            if body and isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant) and \
                    isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("repro_torch", "repro")
        elif isinstance(node, ast.alias):
            node.name = node.name.replace("repro_torch", "repro")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            value = node.value.replace("repro_torch", "repro")
            for old, new in strings.items():
                value = value.replace(old, new)
            node.value = value
    dropped = set()

    def keep(stmt, prefix):
        name = getattr(stmt, "name", None)
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            name = stmt.target.id
        qual = f"{prefix}{name}"
        if name is not None and qual in drop:
            dropped.add(qual)
            return False
        if isinstance(stmt, ast.ClassDef):
            stmt.body = [s for s in stmt.body if keep(s, qual + ".")]
        return True

    tree.body = [s for s in tree.body if keep(s, "")]
    if port:  # an exemption names what the port's file has
        assert dropped == set(drop), f"exempt members not found: {set(drop) - dropped}"
    return tree


def _dump(path: Path, drop=(), strings=None, port=False) -> str:
    return ast.dump(_strip(ast.parse(path.read_text()), drop, strings or {}, port))


def test_every_copied_module_is_checked():
    assert len(COPIED) >= 40
    assert {"campaign/zoo.py", "campaign/runner.py", "core/workload.py",
            "service/decisionlog.py", "faults/__init__.py"} <= set(COPIED)
    assert set(EXEMPT) <= set(COPIED)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_its_reference(rel):
    reason, drop, strings = EXEMPT.get(rel, ("", (), {}))
    assert (REF / rel).exists(), f"{rel} has no reference file"
    port = _dump(PORT / rel, drop, strings, port=True)
    ref = _dump(REF / rel, drop)
    assert port == ref, f"{rel} drifted from src/repro/{rel}" + \
        (f" beyond its exemption ({reason})" if reason else "")


def test_campaign_fixtures_are_the_references_bytes():
    names = sorted(p.name for p in (REF / "campaign" / "fixtures").iterdir())
    assert names == sorted(p.name for p in (PORT / "campaign" / "fixtures").iterdir())
    assert len(names) == 3
    for name in names:
        assert (PORT / "campaign" / "fixtures" / name).read_bytes() == \
            (REF / "campaign" / "fixtures" / name).read_bytes(), name
