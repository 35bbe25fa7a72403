"""The port's command-line tools: the environment check (``doctor``), the
memory report (``memory_report``) and the conditioning check
(``verify_conditioning``), counterparts of the JAX package's ``scripts/``."""
