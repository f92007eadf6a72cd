"""The port's copy of the campaign package against the reference's.

Every case of `tests/test_campaign.py` (the trace zoo, the gzip SWF reader,
the TOML subset, calibration, spec validation, reports, end-to-end
campaigns with checkpoint and resume), run once through `repro.campaign`
and once through `repro_torch.campaign` on the same inputs.  Each run makes
the reference test's own assertions, and the two must give equal outputs:
traces, profiles, parsed specs, cells, aggregates and artifacts.

Then the gate: `examples/campaigns/mini.toml` and `faulty.toml` run
through both packages give `rows.json`, `report.json` and `report.md`
equal byte for byte, and equal to the checked-in
`results/campaigns/<name>/`, apart from `provenance.grid_key`.  That key
hashes `repr(RunSpec)` (`core/experiment.py`, `Experiment._grid_key`), and
the RunSpec's Scenario carries the fixture's absolute path
(`campaign/zoo.py`, `_FIXTURE_DIR`), which names the package and the
checkout.  The CLI, `python -m repro_torch.campaign run ... --offline`,
writes what the in-process run writes.

Everything is offline: every test sets REPRO_OFFLINE and touches only the
checked-in fixtures.
"""
import copy
import gzip
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.campaign as jcampaign  # noqa: E402
import repro.campaign._toml as jtoml  # noqa: E402
import repro.campaign.report as jreport  # noqa: E402
import repro.campaign.spec as jspec  # noqa: E402
import repro.campaign.zoo as jzoo  # noqa: E402
import repro.core.workloads.base as jbase  # noqa: E402
import repro.core.workloads.swf as jswf  # noqa: E402
import repro_torch.campaign as tcampaign  # noqa: E402
import repro_torch.campaign._toml as ttoml  # noqa: E402
import repro_torch.campaign.report as treport  # noqa: E402
import repro_torch.campaign.spec as tspec  # noqa: E402
import repro_torch.campaign.zoo as tzoo  # noqa: E402
import repro_torch.core.workloads.base as tbase  # noqa: E402
import repro_torch.core.workloads.swf as tswf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKGS = (SimpleNamespace(name="repro", campaign=jcampaign, toml=jtoml, report=jreport,
                        spec=jspec, zoo=jzoo, base=jbase, swf=jswf),
        SimpleNamespace(name="repro_torch", campaign=tcampaign, toml=ttoml, report=treport,
                        spec=tspec, zoo=tzoo, base=tbase, swf=tswf))
FIXTURES = ("mini-steady", "mini-bursty", "mini-heavy")
ARTIFACTS = ("rows", "report_json", "report_md")

#: the in-test campaign: 2 traces x 2 mechanisms x 2 seeds x 1 grid point
SPEC_DICT = {
    "campaign": {"name": "t", "mechanisms": ["BASE", "CUA&SPAA"],
                 "seeds": [0, 1], "max_jobs": 120},
    "grid": {"target_load": [0.8], "notice": ["W2"]},
    "trace": [{"name": "mini-steady"}, {"name": "mini-bursty"}],
}


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("REPRO_OFFLINE", "1")


def both(case, *args):
    """`case(P, *args)` for the reference, then for the port; their outputs
    must be equal, compared as JSON text (a NaN equals a NaN).  Returns
    both."""
    ref, port = (case(P, *args) for P in PKGS)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    return ref, port


def _msg(e, P):
    """An error's text with the package's name and directory read out."""
    return str(e.value).replace(str(Path(P.zoo.__file__).parent), "<dir>").replace(
        P.name, "<pkg>")


def _artifacts(paths):
    """The three artifacts' text with the grid_key replaced, and the key."""
    key = json.loads(Path(paths["rows"]).read_text())["provenance"]["grid_key"]
    assert len(key) == 16
    return {k: Path(paths[k]).read_text().replace(key, "<grid_key>") for k in ARTIFACTS}, key


# ------------------------------------------------------------------ trace zoo
def test_zoo_fixtures_resolve_and_verify():
    def case(P):
        out = []
        for name in FIXTURES:
            path = P.campaign.fetch(name)
            assert os.path.exists(path) and path.endswith(".swf.gz")
            assert P.campaign.file_sha256(path) == P.campaign.get_trace(name).sha256
            out.append((os.path.basename(path), P.campaign.file_sha256(path)))
        return out
    both(case)


def test_zoo_unknown_trace_lists_registry():
    def case(P):
        with pytest.raises(P.base.WorkloadDataError, match="mini-steady") as e:
            P.campaign.get_trace("no-such-trace")
        return _msg(e, P)
    both(case)


def test_zoo_sha_mismatch_refused():
    def case(P):
        P.campaign.register_trace(P.campaign.TraceSpec(
            name="tampered-test", description="x", license="x",
            sha256="0" * 64, fixture="mini-steady.swf.gz"))
        try:
            with pytest.raises(P.base.WorkloadDataError, match="sha256 mismatch") as e:
                P.campaign.fetch("tampered-test")
        finally:
            del P.zoo._ZOO["tampered-test"]
        return _msg(e, P)
    both(case)


def test_zoo_offline_refuses_download(tmp_path, monkeypatch):
    def case(P):
        monkeypatch.setenv(P.zoo.CACHE_ENV, str(tmp_path / P.name / "cache"))
        assert P.campaign.get_trace("kth-sp2").remote
        with pytest.raises(P.base.WorkloadDataError, match="offline") as e:
            P.campaign.fetch("kth-sp2", offline=True)
        assert not (tmp_path / P.name / "cache").exists()
        return _msg(e, P).replace(str(tmp_path / P.name), "<tmp>")
    both(case)


def test_zoo_reregistration_conflict():
    def case(P):
        spec = P.campaign.get_trace("mini-steady")
        P.campaign.register_trace(spec)
        with pytest.raises(ValueError, match="already registered") as e:
            P.campaign.register_trace(P.campaign.TraceSpec(
                name="mini-steady", description="different", license="x"))
        return str(e.value), P.zoo.registered_traces()
    both(case)


# ----------------------------------------------------- gzip SWF reader (swf.py)
def test_gzip_reads_identical_to_plain(tmp_path):
    def case(P):
        gz_path = P.campaign.fetch("mini-steady")
        plain = tmp_path / f"{P.name}.swf"
        with gzip.open(gz_path, "rb") as f:
            plain.write_bytes(f.read())
        hdr_gz, hdr_plain = {}, {}
        recs_gz = list(P.swf.iter_swf(gz_path, header=hdr_gz))
        recs_plain = list(P.swf.iter_swf(str(plain), header=hdr_plain))
        assert recs_gz == recs_plain and hdr_gz == hdr_plain
        assert hdr_gz["MaxNodes"] == "64"
        return recs_gz, hdr_gz
    both(case)


def test_truncated_gzip_is_data_error(tmp_path):
    def case(P):
        blob = Path(P.campaign.fetch("mini-steady")).read_bytes()
        bad = tmp_path / f"{P.name}.swf.gz"
        bad.write_bytes(blob[:len(blob) // 2])
        with pytest.raises(P.base.WorkloadDataError, match="corrupt gzip") as e:
            list(P.swf.iter_swf(str(bad)))
        return str(e.value).replace(str(bad), "<path>")
    both(case)


def test_binary_junk_is_data_error(tmp_path):
    def case(P):
        bad = tmp_path / f"{P.name}.swf"
        bad.write_bytes(b"\xfe\xfe\xff\x00" * 64)
        with pytest.raises(P.base.WorkloadDataError, match="not a text SWF") as e:
            list(P.swf.iter_swf(str(bad)))
        return str(e.value).replace(str(bad), "<path>")
    both(case)


def test_missing_fields_padded_with_unknown_marker(tmp_path):
    def case(P):
        short = tmp_path / f"{P.name}.swf"
        short.write_text("; MaxNodes: 8\n1 0 -1 60 4\n")
        (rec,) = list(P.swf.iter_swf(str(short)))
        assert rec["allocated_procs"] == 4 and rec["think_time"] == -1.0
        return rec
    both(case)


# ---------------------------------------------------------------- TOML subset
TOML_TEXT = """
# comment
[campaign]
name = "x"           # trailing comment
seeds = [0, 1,
         2]
scale = 1.5
flag = true
[campaign.sim]
queue_policy = "EASY"
[[trace]]
name = "a"
[[trace]]
name = "b"
target_load = [0.7]
"""


def test_toml_subset_roundtrip():
    def case(P):
        data = P.toml.loads(TOML_TEXT)
        assert data["campaign"]["name"] == "x"
        assert data["campaign"]["seeds"] == [0, 1, 2]
        assert data["campaign"]["scale"] == 1.5
        assert data["campaign"]["flag"] is True
        assert data["campaign"]["sim"]["queue_policy"] == "EASY"
        assert [t["name"] for t in data["trace"]] == ["a", "b"]
        assert data["trace"][1]["target_load"] == [0.7]
        return data
    both(case)


@pytest.mark.parametrize("bad, err", [
    ('x = "unterminated', "unterminated string"),
    ("just a line", "expected 'key = value'"),
    ("x = 2026-01-01", "unsupported value"),
    ("[t]\nx = 1\nx = 2", "duplicate key"),
    ('x = "a" "b"', "trailing garbage"),
])
def test_toml_subset_errors(bad, err):
    def case(P):
        with pytest.raises(P.toml.TomlError, match=err) as e:
            P.toml.loads(bad)
        return str(e.value)
    both(case)


# ---------------------------------------------------------------- calibration
def _profile(p):
    return {k: getattr(p, k) for k in ("n_jobs", "n_nodes", "offered_load")}


def test_profile_matches_fixture_generation():
    def case(P):
        p = P.campaign.profile_trace("mini-steady")
        assert p.n_jobs == 340 and p.n_nodes == 64
        assert 0.7 < p.offered_load < 0.85
        heavy = P.campaign.profile_trace("mini-heavy")
        assert heavy.offered_load > 1.0
        return _profile(p), _profile(heavy)
    both(case)


def test_load_factor_math():
    def case(P):
        p = P.campaign.profile_trace("mini-steady")
        assert p.load_factor(p.offered_load) == pytest.approx(1.0)
        assert p.load_factor(2 * p.offered_load) == pytest.approx(2.0)
        with pytest.raises(ValueError) as e:
            p.load_factor(0.0)
        return p.load_factor(p.offered_load), p.load_factor(2 * p.offered_load), str(e.value)
    both(case)


def _jobs(jobs):
    return [(j.jid, j.jtype.value, j.project, j.submit_time, j.size, j.t_estimate,
             j.t_actual, j.n_min, j.notice_kind.value, j.notice_time, j.est_arrival)
            for j in jobs]


def test_calibrated_scenario_hits_target_load():
    def case(P):
        target = 1.1
        sc = P.campaign.calibrated_scenario("mini-steady", target_load=target, notice="W2")
        assert sc.streamable
        jobs, n_nodes = sc.realize(seed=0)
        span = jobs[-1].submit_time - jobs[0].submit_time
        load = sum(j.size * j.t_actual for j in jobs) / (n_nodes * span)
        assert load == pytest.approx(target, rel=0.01)
        return load, n_nodes, _jobs(jobs)
    both(case)


def test_calibrated_scenario_type_fractions_streamable():
    def case(P):
        sc = P.campaign.calibrated_scenario("mini-bursty", malleable_frac=0.5, od_frac=0.2)
        assert sc.streamable
        assert sc.params["frac_od_projects"] == pytest.approx(0.2)
        assert sc.params["frac_rigid_projects"] == pytest.approx(0.3)
        params = {k: v for k, v in sc.params.items() if k != "path"}
        return sc.label, params, [list(t) for t in sc.transforms]
    both(case)


def test_calibrated_scenario_invalid_fractions():
    def case(P):
        with pytest.raises(ValueError, match="sum <= 1") as e:
            P.campaign.calibrated_scenario("mini-steady", malleable_frac=0.9, od_frac=0.3)
        return str(e.value)
    both(case)


# ------------------------------------------------------------ spec validation
def _spec(**over):
    d = copy.deepcopy(SPEC_DICT)
    for dotted, v in over.items():
        cur = d
        *parents, leaf = dotted.split(".")
        for p in parents:
            cur = cur[p]
        if v is None:
            cur.pop(leaf, None)
        else:
            cur[leaf] = v
    return d


def _cells(spec):
    return [(regime, sc.label, sc.faults, sc.batch_rounds,
             {k: v for k, v in sc.params.items() if k != "path"})
            for regime, sc in spec.cells()]


def test_spec_loads_and_counts_cells():
    """The one meant difference: the port's default output directory is
    results/torch/campaigns/<name>, beside the reference's."""
    def case(P):
        spec = P.campaign.CampaignSpec.from_dict(SPEC_DICT)
        assert spec.n_cells == 2 * 2 * 2
        out = P.spec.default_output_dir(spec)
        assert out.endswith(os.path.join("campaigns", "t"))
        return spec.n_cells, _cells(spec)
    both(case)
    assert jspec.default_output_dir(jcampaign.CampaignSpec.from_dict(SPEC_DICT)) == \
        os.path.join("results", "campaigns", "t")
    assert tspec.default_output_dir(tcampaign.CampaignSpec.from_dict(SPEC_DICT)) == \
        os.path.join("results", "torch", "campaigns", "t")


@pytest.mark.parametrize("over, err", [
    ({"campaign": None}, "missing .campaign."),
    ({"campaign.mechanisms": ["NOPE&X"]}, "mechanism"),
    ({"campaign.mechanisms": []}, "non-empty"),
    ({"campaign.seeds": [0, 0]}, "duplicate seeds"),
    ({"campaign.name": "a b"}, "without spaces"),
    ({"campaign.typo_key": 1}, "unknown key"),
    ({"grid.notice": ["W9"]}, "unknown notice mix"),
    ({"grid.target_load": [3.0]}, "outside"),
    ({"grid.target_load": []}, "non-empty list"),
    ({"grid.bogus_axis": [1]}, "unknown axis"),
    ({"trace": [{"name": "no-such-trace"}]}, "unknown trace"),
    ({"trace": []}, "at least one"),
    ({"grid.od_frac": [0.9], "grid.malleable_frac": [0.9]}, "rigid"),
    ({"grid.batch_rounds": [-5]}, "batch_rounds"),
])
def test_spec_validation_errors(over, err):
    def case(P):
        with pytest.raises(P.campaign.CampaignSpecError, match=err) as e:
            P.campaign.CampaignSpec.from_dict(_spec(**over))
        return str(e.value)
    both(case)


def test_spec_batch_rounds_axis_threads_into_cells():
    def case(P):
        spec = P.campaign.CampaignSpec.from_dict(_spec(**{"grid.batch_rounds": [0, 900]}))
        assert spec.n_cells == 2 * 2 * 2 * 2
        assert {sc.batch_rounds for _r, sc in spec.cells()} == {0.0, 900.0}
        assert any(sc.label.endswith("/b:900") for _r, sc in spec.cells())
        return spec.n_cells, _cells(spec)
    both(case)


def test_spec_toml_file_loads():
    def case(P):
        spec = P.campaign.CampaignSpec.load(str(ROOT / "examples" / "campaigns" / "mini.toml"))
        assert spec.name == "mini" and spec.n_cells == 16
        for _regime, sc in spec.cells():
            assert sc.streamable
        return spec.n_cells, _cells(spec)
    both(case)


def test_spec_per_trace_axis_override():
    def case(P):
        spec = P.campaign.CampaignSpec.from_dict(_spec(**{
            "trace": [{"name": "mini-steady", "target_load": [0.6, 0.9, 1.2]},
                      {"name": "mini-bursty"}]}))
        assert spec.n_cells == (3 + 1) * 2 * 2
        return spec.n_cells, _cells(spec)
    both(case)


# ------------------------------------------------------------------- reports
def _rows():
    rows = []
    for trace in ("a", "b"):
        for mech, od in (("BASE", 2.0), ("CUA&SPAA", 1.0)):
            for seed in range(3):
                rows.append({
                    "regime": {"trace": trace, "target_load": 0.8},
                    "mechanism": mech, "seed": seed,
                    "metrics": {"avg_turnaround_od_h": od + 0.01 * seed,
                                "avg_bounded_slowdown": od,
                                "system_utilization": 0.5}})
    return rows


def test_report_winners_and_determinism():
    def case(P):
        agg1 = P.report.aggregate(_rows())
        assert agg1 == P.report.aggregate(list(reversed(_rows())))
        won = P.report.winners(agg1)
        assert len(won) == 2
        for row in won:
            w = row["winners"]["avg_turnaround_od_h"]
            assert w["mechanism"] == "CUA&SPAA" and w["decisive"]
            assert row["winners"]["system_utilization"]["mechanism"] == "BASE"
            assert not row["winners"]["system_utilization"]["decisive"]
        return agg1, won
    both(case)


def test_bootstrap_ci_is_seeded_by_key():
    def case(P):
        ci = P.report.bootstrap_ci
        lo1, hi1 = ci([1.0, 2.0, 3.0], key="k")
        assert (lo1, hi1) == ci([1.0, 2.0, 3.0], key="k")
        assert ci([5.0], key="k") == (5.0, 5.0)
        nan_lo, nan_hi = ci([], key="k")
        assert np.isnan(nan_lo) and np.isnan(nan_hi)
        return [lo1, hi1], [nan_lo, nan_hi]
    both(case)


# ------------------------------------------------------- end-to-end campaigns
def test_campaign_end_to_end_deterministic(tmp_path):
    def case(P):
        spec = P.campaign.CampaignSpec.from_dict(SPEC_DICT)
        paths1 = P.campaign.run_campaign(spec, out_dir=str(tmp_path / P.name / "1"),
                                         processes=0)
        paths2 = P.campaign.run_campaign(spec, out_dir=str(tmp_path / P.name / "2"),
                                         processes=0)
        for key in ARTIFACTS:
            assert Path(paths1[key]).read_bytes() == Path(paths2[key]).read_bytes(), key
        payload = json.loads(Path(paths1["rows"]).read_text())
        assert len(payload["rows"]) == spec.n_cells
        assert {r["regime"]["trace"] for r in payload["rows"]} == {"mini-steady",
                                                                  "mini-bursty"}
        assert all(r["metrics"]["avg_bounded_slowdown"] >= 1.0 for r in payload["rows"])
        return _artifacts(paths1)[0]
    both(case)


def test_campaign_checkpoint_resume_matches_uninterrupted(tmp_path):
    def case(P):
        spec = P.campaign.CampaignSpec.from_dict(SPEC_DICT)
        baseline = P.campaign.run_campaign(spec, out_dir=str(tmp_path / P.name / "full"),
                                           processes=0)
        out = tmp_path / P.name / "killed"
        out.mkdir()
        exp, _regimes = spec.to_experiment(processes=0)
        ckpt = str(out / "checkpoint.json")
        killed_after = 3
        for i, _result in enumerate(exp.run_stream(checkpoint=ckpt), 1):
            if i == killed_after:
                break
        saved = json.loads(Path(ckpt).read_text())
        assert len(saved["runs"]) == killed_after
        assert saved["grid_key"] == exp.grid_key()
        executed = []
        P.campaign.run_campaign(spec, out_dir=str(out), processes=0,
                                progress=lambda d, t, r: executed.append(
                                    (r.spec.workload.label, r.spec.mechanism, r.spec.seed)))
        assert len(executed) == spec.n_cells == len(set(executed))
        for key in ARTIFACTS:
            assert Path(baseline[key]).read_bytes() == \
                (out / os.path.basename(baseline[key])).read_bytes()
        return executed, _artifacts(baseline)[0]
    both(case)


def test_campaign_checkpoint_refuses_foreign_grid(tmp_path):
    def case(P):
        spec = P.campaign.CampaignSpec.from_dict(SPEC_DICT)
        other = P.campaign.CampaignSpec.from_dict(_spec(**{"campaign.seeds": [7]}))
        out = tmp_path / P.name
        P.campaign.run_campaign(spec, out_dir=str(out), processes=0)
        with pytest.raises(ValueError, match="different"):
            P.campaign.run_campaign(other, out_dir=str(out), processes=0)
        return _artifacts({k: str(out / f) for k, f in zip(
            ARTIFACTS, ("rows.json", "report.json", "report.md"))})[0]
    both(case)


def test_campaign_fresh_discards_checkpoint(tmp_path):
    def case(P):
        spec = P.campaign.CampaignSpec.from_dict(SPEC_DICT)
        other = P.campaign.CampaignSpec.from_dict(_spec(**{"campaign.seeds": [7]}))
        out = tmp_path / P.name
        P.campaign.run_campaign(spec, out_dir=str(out), processes=0)
        paths = P.campaign.run_campaign(other, out_dir=str(out), processes=0, resume=False)
        payload = json.loads((out / "rows.json").read_text())
        assert {r["seed"] for r in payload["rows"]} == {7}
        return _artifacts(paths)[0]
    both(case)


# ------------------------------------------- the gate: the checked-in campaigns
def _run_example(P, name, out):
    spec = P.campaign.CampaignSpec.load(str(ROOT / "examples" / "campaigns" / f"{name}.toml"))
    return P.campaign.run_campaign(spec, out_dir=str(out), offline=True, processes=1)


@pytest.mark.parametrize("name", ("mini", "faulty"))
def test_campaign_artifacts_equal_the_references_and_the_checked_in(tmp_path, name):
    """The port's artifacts equal the reference's byte for byte, and both
    equal results/campaigns/<name>/, apart from provenance.grid_key: it
    hashes repr(RunSpec), which holds the fixture's absolute path (the
    package's directory in this checkout), so it differs between the two
    packages and between checkouts."""
    (ref, ref_key), (port, port_key) = (
        _artifacts(_run_example(P, name, tmp_path / P.name)) for P in PKGS)
    assert port_key != ref_key
    checked_in, _key = _artifacts({k: str(ROOT / "results" / "campaigns" / name / f)
                                   for k, f in zip(ARTIFACTS, ("rows.json", "report.json",
                                                               "report.md"))})
    for k in ARTIFACTS:
        assert port[k] == ref[k], k
        assert port[k] == checked_in[k], k


def test_campaign_cli_writes_what_the_in_process_run_writes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_OFFLINE="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.campaign", "run",
         str(ROOT / "examples" / "campaigns" / "faulty.toml"), "--offline",
         "--out", str(tmp_path / "cli")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "campaign faulty: 4 cells" in out.stdout
    cli = {k: str(tmp_path / "cli" / f) for k, f in
           zip(ARTIFACTS, ("rows.json", "report.json", "report.md"))}
    in_process = _run_example(PKGS[1], "faulty", tmp_path / "in_process")
    for k in ARTIFACTS:
        assert Path(cli[k]).read_bytes() == Path(in_process[k]).read_bytes(), k
    assert not (tmp_path / "results").exists()
