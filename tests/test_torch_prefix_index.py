"""Fleet prefix resume in the port ≡ the JAX package ≡ a check from
scratch: the queue cases of ``tests/test_fleet_memory.py``
(``TestPrefixResumeDifferential``): a re-submitted history, an invalid
one, an extension of a checked parent, divergence after and inside the
deepest anchor, the local checkpoint winning, a contract mismatch, a
torn entry, and the ``.jtc`` row-prefix resume.  Also an index published
by either package serving the other to the same verdict and the same
anchor, and ``check --prefix-index`` in both command lines."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from jepsen_tpu.checkers.segmented import (
    segmented_check_file as jax_check_file,
)
from jepsen_tpu.cli.main import main as jax_main
from jepsen_tpu.history.columnar import pack_jtc
from jepsen_tpu.history.prefix_index import (
    PrefixCheckpointIndex as JaxIndex,
)
from jepsen_tpu.history.store import write_history_jsonl
from jepsen_tpu.history.synth import SynthSpec, synth_history
from jepsen_tpu_torch.__main__ import main as port_main
from jepsen_tpu_torch.checkers.segmented import segmented_check_file
from jepsen_tpu_torch.history.prefix_index import (
    PrefixCheckpointIndex,
    contract_key,
)
from jepsen_tpu_torch.history.store import json_default

from test_torch_pipeline import _stdout

REPO = Path(__file__).resolve().parent.parent
SEG = 100
FAMILIES = ("queue", "linear", "valid?")


def norm(x):
    return json.loads(json.dumps(x, default=json_default))


def verdicts(result):
    return {f: norm(result[f]) for f in FAMILIES}


def write_corpus(path: Path, n: int = 400, seed: int = 5, **anomalies):
    sh = synth_history(SynthSpec(n_ops=n, seed=seed, **anomalies))
    path.parent.mkdir(parents=True, exist_ok=True)
    write_history_jsonl(path, sh.ops)
    return path


def append_ops(dst: Path, base: bytes, n: int, seed: int) -> None:
    tail = synth_history(SynthSpec(n_ops=n, seed=seed)).ops
    with open(dst, "wb") as fh:
        fh.write(base)
        for op in tail:
            fh.write((json.dumps(op.to_json()) + "\n").encode())


def check(path, idx=None, **kw):
    return segmented_check_file(path, segment_ops=SEG, device="cpu",
                                prefix_index=idx, **kw)


def jax_check(path, idx=None, **kw):
    return jax_check_file(path, segment_ops=SEG, device=False,
                          prefix_index=idx, **kw)


@pytest.mark.parametrize("anomalies", [{}, {"lost": 1, "unexpected": 1}],
                         ids=["clean", "invalid"])
def test_resubmitted_history_resumes_to_the_same_verdict(tmp_path,
                                                         anomalies):
    hp = write_corpus(tmp_path / "history.jsonl", **anomalies)
    idx = PrefixCheckpointIndex(tmp_path / "idx")
    zero = check(hp)
    armed = check(hp, idx)
    assert "resumed_from_prefix" not in armed["segmented"]
    fleet = check(hp, idx)
    prov = fleet["segmented"]["resumed_from_prefix"]
    assert prov["offset"] > 0 and prov["substrate"] == "jsonl"
    assert verdicts(fleet) == verdicts(zero) == verdicts(armed) == verdicts(
        jax_check(hp))
    assert zero["valid?"] is (not anomalies)


def test_extension_resumes_from_the_parents_anchors(tmp_path):
    parent = write_corpus(tmp_path / "parent.jsonl", n=300)
    child = tmp_path / "child.jsonl"
    base = parent.read_bytes()
    append_ops(child, base, 80, seed=77)
    idx = PrefixCheckpointIndex(tmp_path / "idx")
    check(parent, idx)
    fleet = check(child, idx)
    prov = fleet["segmented"]["resumed_from_prefix"]
    assert 0 < prov["offset"] <= len(base)
    assert verdicts(fleet) == verdicts(check(child)) == verdicts(
        jax_check(child))


def test_invalid_shared_prefix_still_refutes_the_extension(tmp_path):
    parent = write_corpus(tmp_path / "parent.jsonl", n=300, unexpected=1)
    idx = PrefixCheckpointIndex(tmp_path / "idx")
    assert check(parent, idx)["valid?"] is False
    child = tmp_path / "child.jsonl"
    append_ops(child, parent.read_bytes(), 60, seed=31)
    fleet = check(child, idx)
    assert fleet["segmented"]["resumed_from_prefix"] is not None
    assert fleet["valid?"] is False
    assert verdicts(fleet) == verdicts(check(child)) == verdicts(
        jax_check(child))


def test_divergence_after_the_deepest_anchor_falls_back(tmp_path):
    parent = write_corpus(tmp_path / "parent.jsonl", n=400)
    idx = PrefixCheckpointIndex(tmp_path / "idx")
    check(parent, idx)
    lines = parent.read_bytes().splitlines(keepends=True)
    child = tmp_path / "child.jsonl"
    append_ops(child, b"".join(lines[: 3 * SEG + 1]), 150, seed=99)
    fleet = check(child, idx)
    prov = fleet["segmented"]["resumed_from_prefix"]
    assert prov["offset"] == len(b"".join(lines[: 3 * SEG]))
    assert prov["segment_idx"] == 2
    assert verdicts(fleet) == verdicts(check(child)) == verdicts(
        jax_check(child))


def test_a_divergent_byte_unmatches_the_deeper_anchor(tmp_path):
    parent = write_corpus(tmp_path / "parent.jsonl", n=400)
    idx = PrefixCheckpointIndex(tmp_path / "idx")
    check(parent, idx)
    lines = parent.read_bytes().splitlines(keepends=True)
    boundary2 = len(b"".join(lines[: 2 * SEG]))
    first = json.loads(lines[2 * SEG])
    first["time"] = int(first.get("time") or 0) + 1
    child = tmp_path / "child.jsonl"
    child.write_bytes(b"".join(lines[: 2 * SEG])
                      + json.dumps(first).encode() + b"\n"
                      + b"".join(lines[2 * SEG + 1:]))
    fleet = check(child, idx)
    prov = fleet["segmented"]["resumed_from_prefix"]
    assert prov["offset"] == boundary2 and prov["segment_idx"] == 1
    assert verdicts(fleet) == verdicts(check(child)) == verdicts(
        jax_check(child))


def test_local_checkpoint_wins_over_the_fleet_index(tmp_path):
    hp = write_corpus(tmp_path / "history.jsonl", n=400)
    idx_dir = tmp_path / "idx"
    code = (
        "import sys\n"
        "from jepsen_tpu_torch.checkers.segmented import "
        "segmented_check_file\n"
        f"segmented_check_file(sys.argv[1], segment_ops={SEG}, "
        "device='cpu', prefix_index=sys.argv[2])\n"
    )
    p = subprocess.run(
        [sys.executable, "-c", code, str(hp), str(idx_dir)], cwd=REPO,
        env={**os.environ, "JEPSEN_TPU_SEG_DIE_AFTER": "2"},
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 137, p.stderr[-2000:]
    r = check(hp, PrefixCheckpointIndex(idx_dir), resume=True)
    assert r["segmented"]["resumed"] is True
    assert "resumed_from_prefix" not in r["segmented"]
    assert verdicts(r) == verdicts(jax_check(hp))


def test_a_contract_mismatch_is_never_served(tmp_path):
    hp = write_corpus(tmp_path / "history.jsonl", n=400)
    idx = PrefixCheckpointIndex(tmp_path / "idx")
    check(hp, idx)
    r_opts = check(hp, idx, opts={"delivery": "at-least-once"})
    assert "resumed_from_prefix" not in r_opts["segmented"]
    r_seg = segmented_check_file(hp, segment_ops=50, device="cpu",
                                 prefix_index=idx)
    assert "resumed_from_prefix" not in r_seg["segmented"]
    assert contract_key("jsonl", "queue", SEG, {}) != contract_key(
        "jsonl", "queue", 50, {})


def test_a_torn_entry_falls_back_to_the_next_deepest(tmp_path):
    hp = write_corpus(tmp_path / "history.jsonl", n=400)
    idx = PrefixCheckpointIndex(tmp_path / "idx")
    check(hp, idx)
    entries = sorted((tmp_path / "idx").rglob("*.json"),
                     key=lambda p: p.name)
    assert len(entries) >= 2
    entries[-1].write_bytes(entries[-1].read_bytes()[:40])
    fleet = check(hp, idx)
    prov = fleet["segmented"]["resumed_from_prefix"]
    assert prov["refused_deeper"]
    assert prov["offset"] == int(entries[-2].name[:20])
    assert verdicts(fleet) == verdicts(check(hp))


def test_jtc_rows_resume_by_row_prefix(tmp_path):
    hp = write_corpus(tmp_path / "history.jsonl", n=400, lost=1)
    assert pack_jtc(hp) is not None
    idx = PrefixCheckpointIndex(tmp_path / "idx")
    zero = check(hp)
    assert zero["segmented"]["substrate"] == "jtc"
    check(hp, idx)
    fleet = check(hp, idx)
    prov = fleet["segmented"]["resumed_from_prefix"]
    assert prov["substrate"] == "jtc"
    assert verdicts(fleet) == verdicts(zero) == verdicts(jax_check(hp))


@pytest.mark.parametrize("jtc", [False, True], ids=["jsonl", "jtc"])
@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_an_index_published_by_either_package_serves_the_other(
        tmp_path, publisher, jtc):
    """The layout, contract digest and entry CRC are shared: anchors one
    package publishes resume the other at the same anchor, to the same
    verdict as a check from scratch."""
    hp = write_corpus(tmp_path / "history.jsonl", n=400, duplicated=1)
    if jtc:
        assert pack_jtc(hp) is not None
    idx_dir = tmp_path / "idx"
    if publisher == "jax":
        jax_check(hp, JaxIndex(idx_dir))
        served = check(hp, PrefixCheckpointIndex(idx_dir))
        twin = jax_check(hp, JaxIndex(idx_dir))
    else:
        check(hp, PrefixCheckpointIndex(idx_dir))
        served = jax_check(hp, JaxIndex(idx_dir))
        twin = check(hp, PrefixCheckpointIndex(idx_dir))
    prov = served["segmented"]["resumed_from_prefix"]
    assert prov["substrate"] == ("jtc" if jtc else "jsonl")
    assert prov == twin["segmented"]["resumed_from_prefix"]
    assert verdicts(served) == verdicts(twin) == verdicts(check(hp))
    assert PrefixCheckpointIndex(idx_dir).stats()["entries"] == JaxIndex(
        idx_dir).stats()["entries"] > 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_cli_check_prefix_index(tmp_path, pkg):
    """``check --segment-ops N --prefix-index DIR`` in each command line:
    the first run publishes, the second resumes from a fleet anchor, and
    both write the maps of a check from scratch."""
    hp = write_corpus(tmp_path / "run" / "history.jsonl", n=400, lost=1)
    fn, dev = ((port_main, ["--device", "cpu"]) if pkg == "port"
               else (jax_main, ["--checker", "cpu"]))
    # the delivery given on both runs: a re-check inherits the one
    # results.json records, and an anchor serves only its own contract
    argv = ["check", *dev, "--segment-ops", str(SEG), "--delivery",
            "exactly-once", "--prefix-index", str(tmp_path / "idx"),
            str(hp)]
    rc1, _ = _stdout(fn, argv)
    first = json.loads((hp.parent / "results.json").read_text())
    rc2, _ = _stdout(fn, argv)
    second = json.loads((hp.parent / "results.json").read_text())
    assert rc1 == rc2 == 1
    assert "resumed_from_prefix" not in first["segmented"]
    assert second["segmented"]["resumed_from_prefix"]["offset"] > 0
    want = verdicts(check(hp))
    assert {f: first[f] for f in FAMILIES} == {
        f: second[f] for f in FAMILIES} == want
