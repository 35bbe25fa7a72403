"""The port's command-line tools, counterparts of the JAX repo's ``scripts/``:
the environment check (``doctor``), the memory report (``memory_report``),
the conditioning check (``verify_conditioning``), the measurement tools
(``autotune``, ``serve_bench``, ``scaling_curve``; the bench harness itself
is ``littlegan_tpu_torch/bench.py``), the structured dataset
(``make_structured_data``) and the convergence campaign (``campaign``)."""
