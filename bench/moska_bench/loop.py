"""The closed loop: ``clients`` clients, each with one request in flight,
driven through the engine's public entry points.

One call of ``ServingEngine.run()`` serves the whole run. Each of its
waves admits into free slots (an admission prefills and yields the first
token), runs one decode step of the whole batch (a token for every slot)
and, after the step's synchronize, calls the engine's ``wave_hooks``. The
loop's hook gives every token of the wave the host clock at that moment,
lets each client whose request finished submit its next one (it is
admitted at the next wave, so the batch stays full), and asks the run's
plan whether to go on; when the plan says stop, the hook ends ``run()``
by raising ``StopLoop``.

The loop stays inside one ``run()`` because the engine keeps each slot's
last token in a local of ``run()``: a second call would feed its running
requests token 0.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List

from moska_bench.stats import RequestLog, Window
from moska_bench.traffic import Mix, Traffic

CORPUS_ID = "document"


class StopLoop(Exception):
    """Raised from the wave hook to end ``ServingEngine.run()``."""


@dataclass
class WaveRecord:
    end_s: float
    tokens: int
    model_flops: float


class ClosedLoop:
    def __init__(self, engine, traffic: Traffic, mix: Mix, model: dict,
                 chunks: int, layout):
        self.eng = engine
        self.traffic = traffic
        self.mix = mix
        self.model = model
        self.chunks = chunks
        #: the architecture's layout: its ``prefill`` and ``decode`` count
        #: each token's model FLOPs
        self.layout = layout
        self.corpus_id = CORPUS_ID if mix.shared else None
        self.logs: Dict[int, RequestLog] = {}
        self.requests: Dict[int, object] = {}
        self.finished: List[int] = []
        self.waves: List[WaveRecord] = []
        self._next = 0
        self._plan: Callable[[float], bool] = lambda t: False

    def _pool_index(self, i: int) -> int:
        """Request i's entry of the pool; past its end the pool repeats
        from its second block (the first is the pre-aged one)."""
        n, B = len(self.traffic.prompts), self.mix.clients
        return i if i < n else B + (i - B) % (n - B)

    def submit(self, now: float) -> int:
        j = self._pool_index(self._next)
        self._next += 1
        prompt = self.traffic.prompts[j]
        uid = self.eng.submit(prompt, int(self.traffic.outputs[j]),
                              corpus_id=self.corpus_id)
        self.logs[uid] = RequestLog(now, len(prompt))
        return uid

    def drive(self, plan: Callable[[float], bool]) -> None:
        """Submit every client's first request and serve until ``plan``,
        called with each wave's end time, returns False."""
        self._plan = plan
        now = time.perf_counter()
        for _ in range(self.mix.clients):
            self.submit(now)
        self.eng.wave_hooks.append(self._hook)
        try:
            self.eng.run()
        except StopLoop:
            pass
        finally:
            self.eng.wave_hooks.remove(self._hook)

    def _hook(self) -> None:
        t = time.perf_counter()
        fin = self.eng.scheduler.finished
        ended = list(fin)
        fin.clear()
        n_tok, fl = 0, 0.0
        for r in ended + self.eng.scheduler.active():
            log = self.logs[r.uid]
            self.requests[r.uid] = r
            for j in range(len(log.token_s), len(r.generated)):
                log.token_s.append(t)
                n_tok += 1
                fl += (self.layout.prefill(self.model, log.prompt_len,
                                           self.chunks)
                       if j == 0 else
                       self.layout.decode(self.model, log.prompt_len + j,
                                          self.chunks))
        for r in ended:
            self.finished.append(r.uid)
            self.submit(t)
        self.waves.append(WaveRecord(t, n_tok, fl))
        if not self._plan(t):
            raise StopLoop

    def model_flops(self, window: Window) -> float:
        return sum(w.model_flops for w in self.waves if window.holds(w.end_s))

    def finished_in(self, window: Window) -> List[int]:
        return [u for u in self.finished
                if window.holds(self.logs[u].token_s[-1])]

    def occupancy(self) -> Dict[int, int]:
        """Slot of each request in flight."""
        return {r.uid: r.slot for r in self.eng.scheduler.active()}
