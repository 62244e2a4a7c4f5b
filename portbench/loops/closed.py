"""The closed loop: each client keeps one request in flight and sends
its next one as soon as the last has finished (the mix's think time
after it).  The engine is stepped on this thread; a client learns that
its request finished when the step that finished it returns.

`run` submits every client's first request, opens the window, and steps
until `seconds` have passed.  Each token is stamped on the host clock
when the engine hands it over (`ServeRequest.on_token`), each request
when it is submitted.  `hooks.before` / `hooks.after` run around every
step (the traced run reads the requests' progress there); the untraced
run's are empty.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class Sent:
    """One request as the client saw it."""
    client: int
    prompt_len: int
    max_new_tokens: int
    t_submit: float
    req: object                               # the engine's ServeRequest
    times: List[float] = field(default_factory=list)


@dataclass
class Hooks:
    before: Optional[Callable[[], None]] = None
    after: Optional[Callable[[float], None]] = None


def run(engine, plans, make_request, seconds: float, think_s: float,
        hooks: Hooks, sent: List[Sent]):
    """Fills `sent` in submission order; returns (t_open, t_close)."""
    due = {}                                  # client -> time it may send
    active = {}                               # client -> Sent

    def submit(client: int, now: float) -> None:
        plan = next(plans[client])
        rec = Sent(client, len(plan.prompt), plan.max_new_tokens, now, None)
        rec.req = make_request(plan, len(sent), rec.times.append)
        sent.append(rec)
        active[client] = rec
        engine.submit(rec.req)

    t_open = time.perf_counter()
    for c in range(len(plans)):
        submit(c, t_open)
    t_close = t_open + seconds
    while True:
        if hooks.before is not None:
            hooks.before()
        engine.step()
        now = time.perf_counter()
        if hooks.after is not None:
            hooks.after(now)
        if now >= t_close:
            break
        for c, rec in list(active.items()):
            if rec.req.done:
                del active[c]
                due[c] = now + think_s
        for c, t in list(due.items()):
            if now >= t:
                del due[c]
                submit(c, now)
    return t_open, t_close
