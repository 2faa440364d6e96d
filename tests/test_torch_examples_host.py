"""The host-side example twins against the originals, on the CPU:
``torch_cluster_demo``, ``torch_quickstart``, ``torch_custom_technique``
and the scheduler comparison of ``torch_serve_demo`` print the originals'
lines byte for byte (the twins run with ``--device cpu``; none of these
lines carries a wall time or a device word).
"""

import pytest

from torch_examples_util import load, run_file, run_main


def test_cluster_demo_prints_the_reference_lines():
    want = run_main(load("cluster_demo"))
    got = run_main(load("torch_cluster_demo"), ["--device", "cpu"])
    assert got == want
    print(f"compared {len(want)} lines")


@pytest.mark.parametrize("lb_schedule", [None, "gss,64"])
def test_quickstart_prints_the_reference_lines(monkeypatch, lb_schedule):
    """Both the default runtime schedule and the ``LB_SCHEDULE`` override
    (the repo's OMP_SCHEDULE).  Each in its own interpreter: both print
    their package's registry, which a test run earlier in this process may
    have added to (``test_lint.py`` registers ``lint_polluter_test``)."""
    if lb_schedule is None:
        monkeypatch.delenv("LB_SCHEDULE", raising=False)
    else:
        monkeypatch.setenv("LB_SCHEDULE", lb_schedule)
    want = run_file("quickstart")
    got = run_file("torch_quickstart", ["--device", "cpu"])
    assert got == want
    assert any(f"schedule(runtime) -> {lb_schedule or 'fac2,64'}:" in line
               for line in got)
    print(f"compared {len(want)} lines")


def test_custom_technique_prints_the_reference_lines():
    """Each in its own interpreter: both register ``tfrac`` on their
    package's global registry.  The twin asserts that the device plan of
    its torch graph form equals the host plan, as the original asserts it
    for its jax form."""
    env = {"LB_SCHEDULE": ""}
    want = run_file("custom_technique", env=env)
    got = run_file("torch_custom_technique", ["--device", "cpu"], env=env)
    assert got == want
    assert "plan_chunks:   agrees with host reference" in got[3]
    print(f"compared {len(want)} lines")


def test_serve_demo_scheduler_comparison_matches():
    """The scheduler comparison (``simulate_serving`` over the ragged
    queue) line for line; the decoded tokens are held in
    test_torch_examples_models.py with the reference's parameters."""
    mod = load("torch_serve_demo")
    got = [f"  {t:7s} makespan={r['makespan']:7.3f}s "
           f"p99={r['p99']:6.3f}s imbalance={r['imbalance']:.3f}"
           for t, r in mod.scheduler_comparison().items()]
    want = run_main(load("serve_demo"))
    head = want.index("scheduler comparison (8 replicas, one 3x slower):")
    assert got == want[head + 1:]
    assert len(got) == len(mod.SCHEDULERS)
    print(f"compared {len(got)} lines")
