"""Adaptive consensus-design queries (port of
``blockchain_simulator_tpu/query``): typed threshold searches
(query/spec.py) answered by a deterministic bisection/refinement engine
(query/engine.py) over the sweeps' group dispatch, journaled for kill -9
resume and served as long-running requests (serve/schema.py ``"query"``)."""

from blockchain_simulator_tpu_torch.query.engine import run_query
from blockchain_simulator_tpu_torch.query.spec import QuerySpec, parse_query

__all__ = ["QuerySpec", "parse_query", "run_query"]
