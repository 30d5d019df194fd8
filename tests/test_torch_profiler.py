"""``paddle_tpu_torch.profiler`` against the JAX package's
``paddle_tpu.profiler`` on the CPU.

- ``make_scheduler`` gives the reference's state for each of 20 steps
  under several settings, and the tuple form of ``scheduler`` the same
  windows; the torch profiler records exactly the steps the scheduler
  names (``ProfilerStep#N`` ranges), and calls ``on_trace_ready`` once a
  window.
- Step times are counted (``profiler_step_seconds``, trace windows on
  ``profiler_trace_windows_total``); the host table has the reference's
  columns; ``export`` writes a chrome trace whose names and durations
  hold, as ``tests/test_profiler.py`` asserts of the reference.
- ``device_summary`` on a CPU run of the port's Pipe step lists the
  plain versions' ops (the kernels' dispatcher ops among them), by self
  time; it returns "" when this session recorded no window, as the
  reference's does; ``_classify`` buckets a fixed list of CUDA kernel
  names.
"""
import json
import re

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprof
import paddle_tpu_torch.telemetry as telemetry
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.profiler import device_trace
from test_torch_threads import one_intra_op_thread  # noqa: F401

SCHEDULES = [dict(closed=1, ready=1, record=2, repeat=1),
             dict(closed=2, ready=0, record=3),
             dict(closed=0, ready=2, record=1, repeat=3, skip_first=2),
             dict(closed=1, ready=1, record=1, repeat=0, skip_first=5)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_make_scheduler_follows_the_reference(kw):
    ours, theirs = tprof.make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert [ours(i).name for i in range(20)] == \
        [theirs(i).name for i in range(20)]
    assert [s.name for s in tprof.ProfilerState] == \
        [s.name for s in jprof.ProfilerState]
    assert [(t.name, t.value) for t in tprof.ProfilerTarget] == \
        [(t.name, t.value) for t in jprof.ProfilerTarget]


def test_tuple_scheduler_is_the_references_window():
    ours = tprof.Profiler(scheduler=(2, 5), timer_only=True)
    theirs = jprof.Profiler(scheduler=(2, 5), timer_only=True)
    assert [ours._scheduler(i) .name for i in range(10)] == \
        [theirs._scheduler(i).name for i in range(10)]


def _work(x):
    with tprof.RecordEvent("train_step"):
        with tprof.RecordEvent("forward"):
            y = torch.nn.functional.linear(x, x).relu()
        y.sum().backward()


def test_recorded_steps_windows_and_trace_files(tmp_path):
    telemetry.enable()
    telemetry.reset()
    try:
        seen = []
        handler = tprof.export_chrome_tracing(str(tmp_path / "tr"), "w0")
        p = tprof.Profiler(
            targets=[tprof.ProfilerTarget.CPU],
            scheduler=tprof.make_scheduler(closed=1, ready=1, record=2,
                                           repeat=2),
            on_trace_ready=lambda prof: (seen.append(prof._step),
                                         handler(prof)))
        x = torch.randn(8, 8, requires_grad=True)
        with p:
            for _ in range(9):
                _work(x)
                p.step()
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    assert seen == [4, 8]          # each window ends at its last step
    files = sorted((tmp_path / "tr").iterdir())
    assert [f.name.split(".")[0] for f in files] == ["w0", "w0"]
    steps = []
    for f in files:
        trace = json.loads(f.read_text())
        steps.append(sorted(e["name"] for e in trace["traceEvents"]
                            if e.get("name", "").startswith("ProfilerStep#")))
        assert any(e.get("name") == "train_step"
                   for e in trace["traceEvents"])
    assert steps == [["ProfilerStep#2", "ProfilerStep#3"],
                     ["ProfilerStep#6", "ProfilerStep#7"]]
    assert snap["counters"]["profiler_trace_windows_total"][""] == 2
    assert snap["histograms"]["profiler_step_seconds"][""]["count"] == 9
    assert p._windows == 2 and p._state == tprof.ProfilerState.CLOSED


def test_host_table_export_and_summary_as_the_reference(tmp_path, capsys):
    p = tprof.Profiler(timer_only=True)
    p.start()
    x = torch.randn(8, 8, requires_grad=True)
    for _ in range(3):
        _work(x)
        p.step()
    with tprof.RecordEvent("y" * 70):
        pass
    p.stop()
    assert len(p._step_times) == 3
    out = str(tmp_path / "trace.json")
    p.export(out)
    data = tprof.load_profiler_result(out)
    names = {e["name"] for e in data["traceEvents"]}
    assert {"train_step", "forward", "y" * 63} <= names
    for e in data["traceEvents"]:
        assert e["dur"] >= 0
    text = p.summary()
    assert "train_step" in text

    ref = jprof.Profiler(timer_only=True)
    ref.start()
    with jprof.RecordEvent("train_step"):
        pass
    ref.step()
    ref.stop()
    ref_text = ref.summary()
    capsys.readouterr()
    ours_head = [ln for ln in text.splitlines() if ln.startswith("Name")]
    theirs_head = [ln for ln in ref_text.splitlines()
                   if ln.startswith("Name")]
    assert ours_head == theirs_head and len(ours_head) == 1
    def shape(line):
        return re.sub(r"[0-9.]+", "N", line)

    assert shape(text.splitlines()[0]) == shape(ref_text.splitlines()[0])
    # no window this session: both answer ""
    assert p.device_summary() == "" and ref.device_summary() == ""
    assert tprof.host_event_statistics(
        [("op", 0, 2_000_000, 0, 0), ("op", 0, 4_000_000, 0, 0)]) == \
        jprof.host_event_statistics(
            [("op", 0, 2_000_000, 0, 0), ("op", 0, 4_000_000, 0, 0)])


def test_targets_the_port_cannot_profile_raise():
    with pytest.raises(ValueError, match="CPU and the CUDA card"):
        tprof.Profiler(targets=[tprof.ProfilerTarget.TPU]).start()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.Profiler(targets=[tprof.ProfilerTarget.GPU]).start()
    tprof.Profiler(timer_only=True).stop()  # never started: nothing raises


def test_device_summary_lists_the_plain_versions_ops(tmp_path):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
    from paddle_tpu_torch.optimizer import AdamW

    torch.manual_seed(0)
    # lane-aligned widths, so the FFN takes swiglu_down
    cfg = GPTConfig(vocab_size=64, hidden_size=128, num_layers=2,
                    num_heads=2, intermediate_size=128, max_seq_len=32,
                    recompute=True)
    model = GPTForCausalLMPipe(cfg, device="cpu")
    step = TrainStep(model, model.loss,
                     AdamW(model.named_parameters(), lr=1e-3))
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(0, 64, (2, 16)))
                   for _ in range(2))
    p = tprof.Profiler(targets=[tprof.ProfilerTarget.CPU], scheduler=(1, 2),
                       on_trace_ready=tprof.export_chrome_tracing(
                           str(tmp_path)))
    with p:
        for _ in range(3):
            with tprof.RecordEvent("train_step"):
                step(ids, labels)
            p.step()
    rows = p.device_rows()
    names = {r["name"] for r in rows}
    # under full remat the kernel ops' plain versions run as dispatcher ops
    assert {"paddle_tpu_torch::flash_fwd", "paddle_tpu_torch::rms_norm",
            "paddle_tpu_torch::swiglu_down",
            "paddle_tpu_torch::flash_bwd_fused"} <= names
    calls = {r["name"]: r["calls"] for r in rows}
    assert calls["paddle_tpu_torch::flash_fwd"] == 2 * cfg.num_layers
    assert calls["paddle_tpu_torch::flash_bwd_fused"] == cfg.num_layers
    assert calls["paddle_tpu_torch::swiglu_down"] == 2 * cfg.num_layers
    assert calls["paddle_tpu_torch::rms_norm"] == 4 * cfg.num_layers
    assert all(r["total_us"] >= 0 for r in rows)
    assert "train_step" not in names and not any(
        n.startswith("ProfilerStep#") for n in names)
    table = p.device_summary()
    assert table.splitlines()[0].split() == ["op", "calls", "total_us",
                                             "avg_us", "%"]
    fams = p.device_summary(by_family=True)
    assert "gemm" in fams
    # the exported window reads back into the same rows (its timestamps
    # are rounded µs floats, which move a total a little)
    again = {r["name"]: r for r in p.device_rows(logdir=str(tmp_path))}
    assert set(again) == names
    for r in rows:
        got = again[r["name"]]
        assert got["calls"] == r["calls"], r["name"]
        assert abs(got["total_us"] - r["total_us"]) <= max(
            r["calls"], 0.02 * r["total_us"]), r["name"]
    assert p.device_summary(logdir=str(tmp_path)).splitlines()[0] == \
        table.splitlines()[0]
    assert "-- device ops (torch.profiler) --" in p.summary()


def test_classify_buckets_cuda_kernel_names():
    names = {
        "void flash_fwd_wgmma<128, true, false>(CUtensorMap, CUtensorMap)":
            "port:flash_attention_fwd",
        "void (anonymous namespace)::flash_bwd_wgmma<128, false>(...)":
            "port:flash_attention_bwd",
        "void flash_bwd_dq_wgmma<128, true, false>(...)":
            "port:flash_attention_bwd_dq",
        "void flash_wide::flash_bwd_wide_wgmma<192, true, false>(...)":
            "port:flash_attention_bwd",
        "void flash_wide::flash_bwd_wide_wgmma<256, false, true>(...)":
            "port:flash_attention_bwd_dkv",
        "void flash_f32::bwd_kv_kernel<64, true>(float const*)":
            "port:flash_attention_bwd",
        "void flash_f32::dq_kernel<64>(float const*)":
            "port:flash_attention_bwd_dq",
        "void swiglu_down_wgmma<false>(CUtensorMap)": "port:swiglu_down",
        "void rms_norm_kernel<__nv_bfloat16, float, 4>(...)":
            "port:rms_norm",
        "void add_rms_norm_kernel<float, float, float, 2>(...)":
            "port:add_rms_norm",
        "void paged_attention_int8_kernel<float, 128>(...)":
            "port:paged_attention_int8",
        "nvjet_hsh_256x128_64x4_2x1_v_bz_coopB_NNN": "gemm",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64":
            "gemm",
        "cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_nn_align4>":
            "gemm",
        "sm80_xmma_fprop_implicit_gemm_indexed_f32f32_tf32f32": "conv",
        "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int=512>(...)":
            "conv",
        "Memcpy DtoD (Device -> Device)": "copy",
        "Memset (Device)": "copy",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>>(int)": "elementwise",
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float,"
        " at::native::func_wrapper_t<float, at::native::sum_functor>>>()":
            "reduction",
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)": "nccl",
        "some_unknown_kernel": "other",
    }
    for name, fam in names.items():
        assert device_trace._classify(name) == fam, name
    rows = device_trace.device_op_stats([
        ("k", "device", 0.0, 2.0, 0), ("k", "device", 5.0, 4.0, 0),
        ("Memset (Device)", "device", 10.0, 1.0, 0)])
    assert rows[0] == {"name": "k", "calls": 2, "total_us": 6.0,
                       "avg_us": 3.0, "family": "other"}
    assert device_trace.busy_us([("a", "device", 0.0, 2.0, 0),
                                 ("b", "device", 1.0, 2.0, 0),
                                 ("c", "device", 5.0, 1.0, 0)]) == (4.0, 6.0)


def _cpu_only_window():
    """A window's events with CPU ops and no device event: an op with a
    nested op on one thread (self times 3 and 2 µs) and one on another."""
    return [("aten::linear", "cpu", 0.0, 5.0, 1),
            ("aten::addmm", "cpu", 1.0, 2.0, 1),
            ("aten::relu", "cpu", 0.0, 4.0, 2)]


def test_a_gpu_window_without_device_events_raises(tmp_path):
    """A window that traced the card and recorded no device event never
    yields the CPU ops' table; a CPU-only window keeps it."""
    rows = device_trace.device_op_stats(_cpu_only_window())
    assert {r["name"]: r["total_us"] for r in rows} == {
        "aten::linear": 3.0, "aten::addmm": 2.0, "aten::relu": 4.0}
    with pytest.raises(device_trace.NoDeviceEvents, match="3 CPU ops"):
        device_trace.device_op_stats(_cpu_only_window(), gpu=True)
    dev = _cpu_only_window() + [("k", "device", 1.5, 1.0, 0)]
    assert [r["name"] for r in device_trace.device_op_stats(
        dev, gpu=True)] == ["k"]
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": n, "ts": s, "dur": d, "tid": t}
        for n, _, s, d, t in _cpu_only_window()]}
    path = tmp_path / "w.pt.trace.json"
    path.write_text(json.dumps(trace))
    with pytest.raises(device_trace.NoDeviceEvents):
        device_trace.device_op_stats(str(path), gpu=True)
    assert len(device_trace.device_op_stats(str(path))) == 3
    # the Profiler passes whether its targets held the card
    p = tprof.Profiler(targets=[tprof.ProfilerTarget.CPU])
    p._trace_written, p._device_events = True, _cpu_only_window()
    assert len(p.device_rows()) == 3
    p._gpu = True
    with pytest.raises(device_trace.NoDeviceEvents):
        p.device_rows()
    with pytest.raises(device_trace.NoDeviceEvents):
        p.device_summary()
    with pytest.raises(device_trace.NoDeviceEvents):
        p.device_rows(logdir=str(path))
