"""The program's spans stay out of the benchmark's timed runs: an untraced
run (on the CPU here, at a small image size) installs no tracer, so the
process-global tracer stays the no-op default and no program span opens,
and it prints exactly the keys it printed before the program had spans."""
import json
import os
import subprocess
import sys
import textwrap

from hassbench import harness

ROOT = harness.ROOT

RESULT_KEYS = ["attempted", "checks", "compared", "correct", "device",
               "failed", "metrics"]


def _run_untraced():
    code = textwrap.dedent('''
        import json, time
        from hassbench import harness
        from repro_torch import obs
        cell = harness.find_cell("mobilenetv3l.search.b8")
        out = harness.run(cell, 2147483651, 1.0, False,
                          time.perf_counter(), device="cpu", img_res=32)
        print(json.dumps([sorted(out), sorted(out["metrics"]),
                          sorted(out["device"]),
                          obs.get_tracer() is obs.NULL_TRACER]))
        ''')
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def test_an_untraced_run_prints_todays_keys_and_installs_no_tracer():
    keys, metrics, device, null = _run_untraced()
    assert keys == RESULT_KEYS
    assert metrics == sorted(m["name"] for m in
                             harness.find_cell("mobilenetv3l.search.b8")
                             .end_to_end)
    assert device == ["count", "kind", "memory_peak_bytes", "platform"]
    assert null

