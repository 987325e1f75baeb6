"""Structured per-stage metrics (mirrors tpu_plonk/utils/metrics.py):
one JSON-able record of wall-clock stages and counters, as the CLI's
`demo` prints it.  The reference's NullMetrics is not copied: the
port's prover reports its rounds through `prove_device(timings=)`."""

import time
import contextlib


class Metrics:
    def __init__(self):
        self.records = {}
        self.counters = {}

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name] = self.records.get(name, 0.0) + \
                (time.perf_counter() - t0)

    def count(self, name: str, value: int = 1):
        self.counters[name] = self.counters.get(name, 0) + value

    def to_dict(self) -> dict:
        out = {f"{k}_s": round(v, 6) for k, v in self.records.items()}
        out.update(self.counters)
        return out
