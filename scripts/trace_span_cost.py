"""What the port's spans (`pgmvae_tpu_torch/trace.py`) cost and leave on
the device's timeline, on a CUDA card. Prints two JSON lines: the device
events under a `trace.span` pair and under a `record_function`, and which of
them the benchmark's trace keeps; then the cost of `trace.span` in ns a
call with no profiler (10^6 calls, three times) and inside ten profiler
sessions (10^5 calls each), beside `record_function`'s.

    python3 scripts/trace_span_cost.py
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa

from benchmark import trace as btrace  # noqa: E402
from pgmvae_tpu_torch import trace  # noqa: E402

out = {'python': sys.version.split()[0], 'torch': torch.__version__,
       'cuda': torch.version.cuda,
       'gpu': subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout.strip(),
       'has_fast': hasattr(torch._C._profiler, '_RecordFunctionFast'),
       'has_is_user_annotation': hasattr(torch._C._autograd._KinetoEvent,
                                         'is_user_annotation')}
x = torch.randn(2048, 2048, device='cuda')


def work():
    with trace.span('probe.fast'):
        with trace.span('probe.fast_inner'):
            for _ in range(5):
                x @ x
    with record_function('probe.rf'):
        for _ in range(5):
            x @ x
    torch.cuda.synchronize()


work()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    work()
dev, host = [], []
for e in p.profiler.kineto_results.events():
    ua = e.is_user_annotation() if out['has_is_user_annotation'] else None
    row = [e.name()[:60], ua, e.duration_ns()]
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        dev.append(row)
    elif e.name().startswith('probe'):
        host.append(row + [e.start_ns()])
out['device_events'] = dev
out['host_probe_events'] = host
tr = btrace.traced(work, 'cuda')
out['bench_kept_device_names'] = sorted({k.name[:60] for k in tr.kernels})
out['bench_host_probe'] = [h.name for h in tr.host
                           if h.name.startswith('probe')]
print(json.dumps(out), flush=True)


def loop(n, name='a.b'):
    span = trace.span
    t = time.perf_counter()
    for _ in range(n):
        with span(name):
            pass
    return time.perf_counter() - t


def loop_rf(n):
    t = time.perf_counter()
    for _ in range(n):
        with record_function('a.b'):
            pass
    return time.perf_counter() - t


def empty(n):
    t = time.perf_counter()
    for _ in range(n):
        pass
    return time.perf_counter() - t


cost = {}
loop(10000)
cost['empty_loop_ns'] = empty(10 ** 6) * 1e3
cost['off_ns'] = [loop(10 ** 6) * 1e3 for _ in range(3)]
cost['record_function_off_ns'] = loop_rf(10 ** 5) * 1e4
on, on_rf = [], []
for _ in range(10):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on.append(loop(10 ** 5))
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    on_rf.append(loop_rf(10 ** 5))
cost['on_ns'] = sum(on) / 10 ** 6 * 1e9
cost['on_ns_each_session'] = [t * 1e4 for t in on]
cost['record_function_on_ns'] = on_rf[0] * 1e4
print(json.dumps({'span_cost': cost}), flush=True)
