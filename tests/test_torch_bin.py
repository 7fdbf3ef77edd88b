"""The port's command-line entry points (`zkvm_prover_tpu_torch/bin/`) and
`utils/tracing.py` against the JAX package.

`build_guest`'s asset tree is byte-equal to the reference's
`generate_app_assets` and passes `verify_assets` (a tampered commitment
fails it); `chunk_scanner`'s CSV rows equal the reference's, the timing
column excepted; the tracing spans keep the reference's metrics. Under
`slow`: `--with-evm-verifier`'s `verifier.bin` against the reference's, and
`chunk_benchmark --fast --device cpu`. Entry points given no device raise
on a host with no card."""

import csv
import json

import pytest
import torch

from zkvm_prover_tpu.bin import build_guest as ref_build_guest
from zkvm_prover_tpu.bin import chunk_scanner as ref_chunk_scanner
from zkvm_prover_tpu.utils import tracing as ref_tracing
from zkvm_prover_tpu_torch.bin import build_guest, chunk_benchmark, chunk_scanner
from zkvm_prover_tpu_torch.utils import tracing



def no_card():
    """Skip a check of the behaviour of a host with no card where there is one."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host with no card")


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_build_guest_assets_equal_reference(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "reference"
    index = build_guest.generate_app_assets(ours)
    assert index == ref_build_guest.generate_app_assets(theirs)
    assert _tree(ours) == _tree(theirs)
    assert set(index) == {"chunk", "batch", "bundle"}
    assert build_guest.verify_assets(ours)
    assert ref_build_guest.verify_assets(ours)
    # child commitments thread chunk -> batch -> bundle
    assert json.loads((ours / "batch" / "child_commitments.json").read_text()) == \
        json.loads((ours / "chunk" / "commitments.json").read_text())
    assert (ours / "bundle" / "digest_1.hex").read_text() == "0x" + index["bundle"]["exe_commit"]
    (ours / "chunk" / "commitments.json").write_text(
        json.dumps({"exe": "00" * 32, "vm": "11" * 32}))
    assert not build_guest.verify_assets(ours)


def test_build_guest_main_and_verifier_setup(tmp_path, capsys):
    assert build_guest.main(["--output", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["apps"] == \
        ["chunk", "batch", "bundle"]
    from zkvm_prover_tpu_torch.host.verifier import UniversalVerifier

    assert UniversalVerifier.setup(str(tmp_path / "chunk")).app.name == "chunk"


@pytest.mark.slow
def test_build_guest_evm_verifier_equals_reference(tmp_path):
    (tmp_path / "reference").mkdir()      # the reference writes into an existing tree
    meta = build_guest.generate_evm_verifier_assets(tmp_path / "port", device="cpu")
    ref_meta = ref_build_guest.generate_evm_verifier_assets(tmp_path / "reference")
    assert meta == ref_meta
    assert (tmp_path / "port" / "verifier.bin").read_bytes() == \
        (tmp_path / "reference" / "verifier.bin").read_bytes()


def _rows(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        assert float(r.pop("exec_seconds")) >= 0
    return rows


def test_chunk_scanner_csv_equals_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "run"))
    ours, theirs = tmp_path / "port.csv", tmp_path / "reference.csv"
    assert chunk_scanner.main(["--chunks", "2", "--out", str(ours)]) == 0
    assert ref_chunk_scanner.main(["--chunks", "2", "--out", str(theirs)]) == 0
    rows = _rows(ours)
    assert rows == _rows(theirs)
    assert [r["chunk"] for r in rows] == ["0", "1"] and int(rows[0]["total_rows"]) > 0


def test_tracing_spans_equal_reference():
    for mod in (tracing, ref_tracing):
        mod.reset()
        with mod.span("a/b", cycles=10):
            pass
        with mod.span("a/b", cycles=5):
            pass
        with mod.span("c"):
            pass
    ours, theirs = tracing.report(), ref_tracing.report()
    assert set(ours) == set(theirs) == {"a/b", "c"}
    for k in ours:
        assert {f: v for f, v in ours[k].items() if f != "total_ms"} == \
            {f: v for f, v in theirs[k].items() if f != "total_ms"}
        assert ours[k]["total_ms"] >= 0
    assert ours["a/b"] == {**ours["a/b"], "calls": 2, "cycles": 15}
    assert tracing.logger.name == "zkvm_prover_tpu_torch"
    tracing.reset()
    assert tracing.report() == {}


def test_tracing_dump_metrics(tmp_path):
    tracing.reset()
    with tracing.span("x", cycles=3):
        pass
    path = tmp_path / "metrics.json"
    tracing.dump_metrics(str(path))
    assert json.loads(path.read_text())["x"]["cycles"] == 3
    tracing.reset()


def test_bins_without_a_card_raise(tmp_path):
    no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chunk_benchmark.main(["--metrics", str(tmp_path / "m.json"), "--fast"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_guest.generate_evm_verifier_assets(tmp_path)


@pytest.mark.slow
def test_chunk_benchmark_fast_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "run"))
    tracing.reset()
    metrics = tmp_path / "metrics.json"
    chunk_benchmark.main(["--metrics", str(metrics), "--fast", "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["cycles_per_gas"] <= 35
    assert set(json.loads(metrics.read_text())) == {"chunk/execute", "chunk/prove"}
    tracing.reset()
