"""BENCHMARK.json against the benchmark's contract, and the harness's
lookups by name."""

import json
import os
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def data():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_files(data):
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert data["paths"] == ["benchmark"]
    assert 1 <= data["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in data[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in data[k]}) == len(data[k])
    metrics = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in data["workloads"])
    pairs = set()
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(json.dumps(data)) < 64 * 1024


def test_metrics(data):
    cells = {w["name"] for w in data["workloads"]}
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for m in data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in data["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        spec.metric_reader(m["name"])  # every metric has its reader
    for c in cells:  # each cell reports set-up, another e2e, a layer
        sp = spec.Spec()
        assert len(sp.end_to_end(c)) >= 2 and sp.per_layer(c)


def test_lookups_by_name_and_refusals():
    sp = spec.Spec()
    assert sp.cell("nizk-2p20.prove-verify")["config"] == "nizk-2p20"
    assert sp.config("snark-2p20")["protocol"] == "snark"
    assert spec.traffic("prove-verify")["steps"] == ["prove", "verify"]
    assert hasattr(spec.metric_reader("rt.fetches"), "read")
    for fn, arg in ((sp.cell, "no-such.cell"), (sp.config, "no-such"),
                    (spec.traffic, "no-such-mix"),
                    (spec.metric_reader, "no.such_metric")):
        with pytest.raises(spec.UnknownName):
            fn(arg)


def test_run_refuses_an_unknown_cell():
    from benchmark import run

    with pytest.raises(spec.UnknownName):
        run.main(["--workload", "no-such.cell", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])


PROVE_CELLS = {
    "nizk-2p20.prove-verify": [
        "r1cs.phase_one_s", "r1cs.polycommit_s", "rt.fetches",
        "kernels.fold_evals_roofline", "kernels.row_msm_roofline",
        "device.idle_share.prove"],
    "snark-2p20.prove-verify": [
        "r1cs.phase_one_s", "r1cs.polycommit_s", "spark.eval_proof_s",
        "spark.layer_rounds_s", "rt.fetches", "kernels.fold_evals_roofline",
        "device.idle_share.prove"],
}


@pytest.mark.parametrize("cell", sorted(PROVE_CELLS))
def test_the_prove_cells_metrics_as_before(cell):
    sp = spec.Spec()
    assert [m["name"] for m in sp.end_to_end(cell)] == [
        "prove_s", "peak_mem_bytes", "setup_s"]
    assert [m["name"] for m in sp.per_layer(cell)] == PROVE_CELLS[cell]
    assert sp.cell(cell)["traffic"] == "prove-verify"
