"""The port's drivers: the experiment CLI (``run``), the in-process sweep
(``sweep``), the float64 certifier of artifacts (``certify``), the
per-operator timer (``bench_micro``) and the fused-versus-host dual-time
A/B (``ab_dualtime``); ``sdplrplus_tpu_torch.bench`` is the headline
benchmark. Each runs as ``python -m sdplrplus_tpu_torch.exps.<name>``.
"""
