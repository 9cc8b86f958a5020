"""Whole runs at tiny sizes on the CPU (the look for a card skipped):
the import check, the controls, planted faults, and a configuration, a
traffic mix, a per-layer metric and a cell added by files alone."""

import json
import math
import subprocess
import sys

import pytest

from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_run_loads_no_jax(root):
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "r = harness.run('bf16-paged-b8-stream', 3, 2.0, False, Path(%r), "
        "time.perf_counter(), device='cpu')\n"
        "assert r['correct'], r['_numbers']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'qwen3_tts_tpu'}))\n"
        "print('qwen3_tts_tpu_torch' in sys.modules)\n"
    ) % (str(tiny.REPO), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:2] == ["[]", "True"]


def test_a_metric_that_loads_jax_gives_no_result(root, tmp_path):
    """run.py, with the look for a card passed, over a copy whose set-up
    metric imports a module named jax: exit 3, no result, the module
    named on standard error."""
    import shutil
    dst = tmp_path / "jaxy"
    shutil.copytree(root, dst)
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    reader = dst / "benchmark" / "metrics" / "setup_s.py"
    reader.write_text("import sys\nsys.path.insert(0, %r)\nimport jax  "
                      "# noqa\n" % str(tmp_path / "stub")
                      + reader.read_text())
    code = (
        "import sys, torch; sys.path.insert(0, %r); sys.path.append(%r)\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "from benchmark import harness, run\n"
        "real = harness.run\n"
        "harness.run = lambda *a, **k: real(*a, device='cpu', **k)\n"
        "sys.exit(run.main(['--workload', 'bf16-paged-b8-stream', "
        "'--seed', '3', '--seconds', '2', '--trace', '0']))\n"
    ) % (str(dst), str(tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 3, out.stderr[-3000:]
    assert out.stdout == "" and "jax" in out.stderr.splitlines()[-1]


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.check, benchmark.reference.model\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('qwen3_tts_tpu_torch', 'qwen3_tts_tpu', 'jax')))\n"
    ) % str(tiny.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell", ["int8-b8-offline",
                                  "bf16-paged-b8-stream"])
def test_each_control_fails_where_the_program_passes(root, cell):
    """Each control one precision step down at a tiny size: the program
    correct and the code predictor's control not, by the same limits; the
    int4 talker's control far from the program on its mean code-0 gap.
    At these widths the talkers' controls stay within the token limit
    (which the published widths cross, PERF.md), and the vocoder's
    (TF32) exists only on a card."""
    r = tiny.run(root, cell, seed=11, control=True)
    assert r["correct"], r["_numbers"]
    ctl = r["_control"]
    assert set(ctl) == {"talker", "code_predictor", "vocoder"}
    assert ctl["code_predictor"]["correct"] is False, ctl["code_predictor"]
    if cell.startswith("int8"):
        assert ctl["talker"]["code0_gap_mean"] > 1e-3 > 100 * r[
            "_numbers"]["code0_gap_mean"]


def _fault(monkeypatch, where):
    from qwen3_tts_tpu_torch.models import code_predictor as cpm
    from qwen3_tts_tpu_torch.ops import sampling as smp
    from qwen3_tts_tpu_torch.serve import batching
    if where == "code0":
        real = smp.sample_code0

        def bad(*a, **k):
            tok = real(*a, **k)
            return torch_where_audio(tok, (tok + 1) % 2048)
        monkeypatch.setattr(smp, "sample_code0", bad)
    elif where == "group":
        real = cpm.predict_codes

        def bad(*a, **k):
            out = real(*a, **k).clone()
            out[:, 6] = (out[:, 6] + 3) % 2048
            return out
        monkeypatch.setattr(cpm, "predict_codes", bad)
    else:
        real = batching.vocode

        def bad(*a, **k):
            audio = real(*a, **k).copy()
            audio[len(audio) // 2] += 40
            return audio
        monkeypatch.setattr(batching, "vocode", bad)


def torch_where_audio(tok, alt):
    import torch
    return torch.where(tok < 2048, alt.to(tok.dtype), tok)


@pytest.mark.parametrize("where", ["code0", "group", "audio"])
def test_a_token_or_an_answer_altered_is_not_correct(root, monkeypatch,
                                                     where):
    _fault(monkeypatch, where)
    r = tiny.run(root, "int8-b8-offline", seed=12)
    assert r["correct"] is False
    bad = [k for k, v in r["compared"].items() if v["value"] > v["limit"]]
    assert bad == (["audio_lsb"] if where == "audio" else ["token_gap"])


def test_added_by_files_alone(root, tmp_path):
    """A dummy configuration, traffic mix, per-layer metric and cell,
    added as new files and entries: the run reads them by name."""
    import shutil
    dst = tmp_path / "ext"
    shutil.copytree(root, dst)
    bench = dst / "benchmark"
    cfg = json.loads((bench / "configs" / "qwen3-tts-0.6b-bf16.json")
                     .read_text())
    cfg["name"] = "dummy-config"
    cfg["batcher"] = {"batch_size": 2, "quantize_talker": False,
                      "quantize_cp": True, "paged": False,
                      "pipeline_depth": 1}
    (bench / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps({
        "kind": "open_poisson", "rate_per_s": 2.0, "stream": False,
        "decode_chunk": 4,
        "n_text": {"dist": "uniform", "min": 3, "max": 6}}))
    (bench / "metrics" / "dummy_requests.py").write_text(
        'UNIT = "requests"\n\n\n'
        'def read(rec):\n    return float(len(rec["requests"]))\n')
    m = json.loads((dst / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "dummy-config", "source": "dummy",
                         "file": "benchmark/configs/dummy-config.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                           "traffic": "dummy_mix", "chips": 1,
                           "why": "a test"})
    for e in m["end_to_end"]:
        if e["name"] == "audio_s_per_s":
            e["workloads"].append("dummy-cell")
    m["per_layer"].append({"name": "dummy_requests", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "test", "moves": "audio_s_per_s",
                           "workloads": ["dummy-cell"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(m))
    r = tiny.run(dst, "dummy-cell", seed=13, seconds=2.0, trace=True)
    assert r["correct"]
    assert r["metrics"]["dummy_requests"]["value"] >= 4
    assert math.isfinite(r["_numbers"]["token_gap"])


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """The command as BENCHMARK.json gives it, short, on a card: one JSON
    line, correct, on the GPU (skips without a card)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "int8-b8-offline",
         "--seed", str(2 ** 31 + 7), "--seconds", "5", "--trace", "0"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "compared"


def test_no_card_no_result():
    """Without a card the command exits 2 and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "int8-b8-offline",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
