"""The port's profiling and bench tools on the CPU: ``utils.profiling``,
``utils.benchmark``, ``trace_summary``, ``profile_stages``, ``bench_avq``
and ``bench_e2e``, and the one trace format that ``bench_train --trace``,
``train_epoch``'s ``profile_dir`` and ``profile_stages --trace`` write.

The JAX package's ``AverageMeter`` and ``benchmark`` are the spec for
theirs. ``trace_summary`` is held to a Chrome trace the test writes (device
kernels, runtime launch calls and the launcher regions that
``ops._build.launch`` opens while the profiler records; the CPU has no
kernels to launch) and reads the traces ``utils.profiling.trace`` writes
around CPU work. The tools run at tiny configs registered or patched in
(the full towers are too slow for this CPU), each printing its JSON keys;
the card runs them at full size in ``chip_smoke.py``'s ``tools`` phase.
"""
import json

import numpy as np
import pytest
import torch

from qa_tiger_tpu.utils import benchmark as j_benchmark
from qa_tiger_tpu.utils import profiling as j_profiling
from qa_tiger_tpu_torch import bench_avq, bench_e2e, bench_train, profile_stages, trace_summary
from qa_tiger_tpu_torch.models import clip_image, clip_text, qa_tiger_config, vit
from qa_tiger_tpu_torch.pipeline.e2e import e2e_config
from qa_tiger_tpu_torch.utils import profiling
from qa_tiger_tpu_torch.utils.benchmark import benchmark

TOWER = "tiny-tools"
TINY_TOWER = dict(width=64, heads=4, layers=2, embed_dim=64)
TOY = dict(d_model=32, video_dim=64, patch_dim=48, audio_dim=16, topK=2, num_experts=4,
           encoder_type=TOWER)


@pytest.fixture
def tower(monkeypatch):
    monkeypatch.setitem(clip_text.CLIP_TEXT_CONFIGS, TOWER, TINY_TOWER)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_average_meter_equals_jax():
    ours, theirs = profiling.AverageMeter(), j_profiling.AverageMeter()
    rng = np.random.default_rng(0)
    for step in range(5):
        vals = [("loss", float(rng.random())), ("acc", float(rng.random()))]
        ours.update(vals, step + 1)
        theirs.update(vals, step + 1)
    for key in ("loss", "acc", "missing"):
        assert ours.get(key) == theirs.get(key)
    ours.reset()
    assert ours.count == 0 and ours.get("loss") == 0.0


def test_benchmark_casts_to_bf16_and_gives_a_rate():
    seen = []

    def fn(x, pair, ids, scale=None):
        seen.append((x.dtype, pair[0].dtype, ids.dtype, scale.dtype))
        return {"y": x.float().sum() + pair[0].float().sum(), "n": ids + 1}

    args = (torch.ones(4, 3), (torch.zeros(2),), torch.arange(3))
    rate = benchmark(fn, *args, runs=8, use_bf16=True, items_per_call=4,
                     scale=torch.ones(1, dtype=torch.float64))
    assert rate > 0 and len(seen) == 9  # the first call, 2 warm-up, 6 timed
    assert set(seen) == {(torch.bfloat16, torch.bfloat16, torch.int64, torch.bfloat16)}
    seen.clear()
    benchmark(fn, *args, runs=4, scale=torch.ones(1))
    assert set(seen) == {(torch.float32, torch.float32, torch.int64, torch.float32)}
    with pytest.raises(ValueError, match="no timed run"):
        benchmark(fn, *args, runs=1, scale=torch.ones(1))
    # JAX's harness counts its runs the same way: 8 runs, throw_out 0.25
    j_rate = j_benchmark.benchmark(lambda x: x * 2, np.ones(3, np.float32), runs=8)
    assert j_rate > 0


def test_trace_is_a_noop_without_a_directory():
    with profiling.trace(None) as prof:
        torch.ones(2).sum()
    assert prof is None
    with profiling.trace("") as prof:
        pass
    assert prof is None


def _event(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "pid": pid, "args": args}


def synthetic_trace() -> list:
    """A profiled window of 100 us: two qt_attn_ln2 regions whose launches
    made three kernels each (the second region's tied only by External id,
    its runtime calls missing), a qt_attention region whose kernel the trace
    lacks, a second thread's qt_attention region whose launch made a cuBLAS
    kernel, a first-thread launch in that region's time span that it must
    not capture, and a memset."""
    ev = [_event("Trace", "PyTorch Profiler (0)", 0.0, 100.0, tid="PyTorch Profiler",
                 pid="Spans")]
    ev += [_event("user_annotation", "qt_attn_ln2", 10.0, 5.0, **{"External id": 1}),
           _event("user_annotation", "qt_attn_ln2", 20.0, 5.0, **{"External id": 2}),
           _event("user_annotation", "qt_attention", 30.0, 5.0, **{"External id": 3}),
           _event("user_annotation", "qt_attention", 40.0, 30.0, tid=2, **{"External id": 4})]
    kernels = ["void qt::layer_norm_kernel<bf16>(x)", "void qt::gemm_sm90_kernel<256>(y)",
               "void qt::attention_mma_kernel<64, true>(z)"]
    for i, name in enumerate(kernels):
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", 11.0 + i, 0.5, correlation=i,
                         **{"External id": 1}))
        ev.append(_event("kernel", name, 50.0 + 4 * i, 2.0, tid=7, pid=0, correlation=i,
                         **{"External id": 1}))
        ev.append(_event("kernel", name, 62.0 + 4 * i, 2.0, tid=7, pid=0, correlation=10 + i,
                         **{"External id": 2}))
    ev.append(_event("cuda_runtime", "cudaLaunchKernel", 31.0, 0.5, correlation=20))
    ev.append(_event("cuda_runtime", "cudaLaunchKernel", 45.0, 0.5, tid=2, correlation=21))
    ev.append(_event("kernel", "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", 51.0, 10.0,
                     tid=8, pid=0, correlation=21))
    ev.append(_event("cuda_runtime", "cudaLaunchKernel", 45.0, 0.5, correlation=22))
    ev.append(_event("kernel", "void at::native::elementwise_kernel<128>(f)", 80.0, 3.0,
                     tid=7, pid=0, correlation=22))
    ev.append(_event("gpu_memset", "Memset (Device)", 90.0, 1.0, tid=7, pid=0))
    return ev


def test_trace_summary_on_a_written_trace(tmp_path, capsys):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": synthetic_trace()}))
    s = trace_summary.summarize(path)
    assert s["kernels"]["void qt::gemm_sm90_kernel<256>(y)"] == (2, 4.0)
    assert s["kernels"]["Memset (Device)"] == (1, 1.0)
    routines = s["routines"]
    assert routines["gemm_sm90"] == (2, 4.0) and routines["attention mma"] == (2, 4.0)
    assert routines["LayerNorm"] == (2, 4.0) and routines["cuBLAS"] == (1, 10.0)
    assert routines["copies and fills"] == (1, 1.0) and routines["other PyTorch"] == (1, 3.0)
    # busy is the union: [50, 61] covers the kernels at 50-52, 54-56, 58-60
    assert s["busy_ms"] == pytest.approx((11 + 2 + 2 + 2 + 3 + 1) / 1e3)
    assert s["device_sum_ms"] == pytest.approx(26 / 1e3)
    assert s["window_ms"] == pytest.approx(0.1)
    assert s["idle_share"] == pytest.approx(0.79)
    ln2 = s["port_launches"]["fused_attn_ln2"]
    assert (ln2["launcher"], ln2["launches"], ln2["traced"]) == ("qt_attn_ln2", 2, 2)
    assert sorted(ln2["kernels"].values()) == [2, 2, 2]
    attn = s["port_launches"]["attention_wide"]
    assert (attn["launches"], attn["traced"]) == (2, 1)
    assert attn["kernels"] == {"nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT": 1}
    trace_summary.main([str(tmp_path), "--by-class", "--top", "3"])
    out = capsys.readouterr().out
    assert "device time by routine" in out and "idle share 0.7900" in out
    assert "fused_attn_ln2" in out and "qt_attention" in out


def test_trace_summary_reads_a_profiled_cpu_call(tmp_path, capsys):
    with profiling.trace(tmp_path, "cpu.json") as prof:
        with profiling.annotate("qt_attention"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert prof is not None and (tmp_path / "cpu.json").exists()
    s = trace_summary.summarize(tmp_path / "cpu.json")
    assert s["kernels"] == {} and s["busy_ms"] == 0.0 and s["window_ms"] > 0
    assert s["idle_share"] == pytest.approx(1.0)
    # the region is there; the CPU launched no kernel in it
    assert s["port_launches"]["attention_wide"]["launches"] == 1
    assert s["port_launches"]["attention_wide"]["traced"] == 0
    names = {e["name"] for e in trace_summary.load_events(tmp_path)}
    assert "aten::mm" in names
    trace_summary.main([str(tmp_path / "cpu.json")])
    assert "busy 0.0000 ms" in capsys.readouterr().out


def test_bench_train_trace_reads_in_trace_summary(monkeypatch, tmp_path, capsys):
    """``bench_train --device cpu --trace`` writes through
    ``utils.profiling.trace``; ``trace_summary`` reads the file."""
    monkeypatch.setitem(clip_text.CLIP_TEXT_CONFIGS, TOWER, TINY_TOWER)
    monkeypatch.setattr(bench_train, "MODEL", dict(TOY, num_labels=42))
    monkeypatch.setattr(bench_train, "T", 6)
    monkeypatch.setattr(bench_train, "P", 4)
    bench_train.main(["--device", "cpu", "--batch", "2", "--iters", "1", "--repeats", "1",
                      "--trace", str(tmp_path)])
    capsys.readouterr()
    s = trace_summary.summarize(tmp_path / bench_train.TRACE_FILE)
    assert s["window_ms"] > 0 and s["kernels"] == {}
    names = {e["name"] for e in trace_summary.load_events(tmp_path)}
    assert "aten::addmm" in names or "aten::linear" in names


def test_profile_stages_on_the_cpu(tower, monkeypatch, tmp_path, capsys):
    """``python -m qa_tiger_tpu_torch.profile_stages --device cpu`` at a tiny
    config: a line per stage, the JSON line, the trace written and read."""
    monkeypatch.setattr(profile_stages, "MODEL", dict(TOY))
    monkeypatch.setattr(profile_stages, "T", 6)
    monkeypatch.setattr(profile_stages, "P", 4)
    monkeypatch.setattr(profile_stages, "ITERS", 2)
    line = profile_stages.main(["--device", "cpu", "--batch", "3", "--dtype", "float32",
                                "--trace", str(tmp_path)])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert line["metric"] == "profile_stages_ms" and line["device"] == "cpu"
    stages = line["stages_ms"]
    assert set(stages) == {"FULL forward", "text tower", *profile_stages.PARTITION}
    assert all(v > 0 for v in stages.values())
    assert line["sum_ms"] == pytest.approx(sum(stages[k] for k in profile_stages.PARTITION))
    assert "SUM of stages vs full" in out and "avq_cross_attn" in out
    assert line["trace_launches"] == {}  # the CPU runs the plain versions
    s = trace_summary.summarize(tmp_path / profile_stages.TRACE_FILE)
    assert s["window_ms"] > 0 and s["port_launches"] == {}


@pytest.mark.parametrize("flags,metric", [
    (["--plain"], "avq_train_ms"),
    (["--plain", "--fwd-only"], "avq_fwd_ms"),
    ([], "avq_train_ms"),
])
def test_bench_avq_on_the_cpu(capsys, flags, metric):
    line = bench_avq.main(["--device", "cpu", "--N", "2", "--T", "4", "--S", "5", "--D", "16",
                           "--nhead", "2", "--steps", "2", *flags])
    assert _last_json(capsys) == line
    assert line["metric"] == metric and line["unit"] == "ms" and line["value"] > 0
    keys = {"metric", "value", "unit", "build_s", "plain", "shape", "device"}
    if metric == "avq_fwd_ms":
        assert set(line) == keys | {"first_call_s"}
    else:
        assert set(line) == keys | {"fwd_ms", "fwd_first_call_s", "bwd_first_call_s"}
    assert line["device"] == "cpu" and line["shape"] == [2, 4, 5, 16, 2]


def test_bench_e2e_on_the_cpu(tower, monkeypatch, capsys):
    """``bench_e2e --device cpu`` with its towers swapped for tiny ones
    (``e2e_config`` patched): one JSON line with the JAX script's keys."""
    monkeypatch.setitem(vit.VIT_CONFIGS, "tiny-vit",
                        dict(img_size=32, patch_size=8, width=48, depth=2, heads=4,
                             ln_eps=1e-6))
    monkeypatch.setitem(clip_image.CLIP_VISION_CONFIGS, "tiny-vis",
                        dict(input_resolution=32, patch_size=8, width=48, layers=2, heads=4,
                             output_dim=TOY["video_dim"]))
    monkeypatch.setattr(bench_e2e, "MODEL", dict(TOY, audio_dim=128, patch_dim=48,
                                                 num_labels=42))
    monkeypatch.setattr(bench_e2e, "e2e_config", lambda model: e2e_config(
        model, clip_encoder="tiny-vis", tome_model="tiny-vit", tome_r=3, tome_layers=2))
    line = bench_e2e.main(["--device", "cpu", "--batch", "1", "--frames", "2", "--iters", "1",
                           "--repeats", "2", "--dtype", "float32"])
    assert _last_json(capsys) == line
    assert set(line) == {"metric", "value", "unit", "frames_per_video", "realtime_factor",
                         "qa_pairs_per_sec", "rates", "device"}
    assert line["metric"] == "e2e_raw_media_videos_per_sec" and line["unit"] == "videos/s"
    assert line["value"] > 0 and line["frames_per_video"] == 2 and len(line["rates"]) == 2
    assert line["device"] == "cpu"


def test_the_tools_refuse_to_fall_back_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (profile_stages.main, bench_avq.main, bench_e2e.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])


def test_e2e_config_of_bench_e2e_is_the_jax_scripts():
    cfg = e2e_config(qa_tiger_config(**bench_e2e.MODEL))
    assert cfg["clip_encoder"] == "ViT-L/14@336px" and cfg["tome_model"] == "vit_large_patch16_384"
    assert cfg["tome_r"] == [25] * 23 and cfg["model"]["video_dim"] == 768
