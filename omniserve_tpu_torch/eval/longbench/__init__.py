"""LongBench through the port's engine: prompts and predictions
(``pred``), scoring (``eval``) and the task metrics (``metrics``)."""
