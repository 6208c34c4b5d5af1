"""The scenario server end to end over ``local://`` on the CPU
(tests/test_torch_serve.py's engine and shape): window batching
coalesces and every reply is the engine's batch-of-1 answer, continuous
batching replies byte-equal to batch-of-1 runs, and a bf16 server with
the strict telemetry gate replies as the bf16 engine.  In a file of its
own so that a run of the suite that splits its workers by file takes
these runs apart from tests/test_torch_serve.py's.
"""

import asyncio
import json

from test_torch_serve import _run, req, scen_of, tcfg, teng  # noqa: F401
from tmhpvsim_torch.obs.metrics import MetricsRegistry as TRegistry
from tmhpvsim_torch.serve import schema as tschema
from tmhpvsim_torch.serve import server as tserver
from test_torch_threads import one_torch_thread  # noqa: F401


def _serve_cfg(url, **kw):
    return tserver.ServeConfig(sim=tcfg(), url=url, window_s=0.25,
                               batch_sizes=(1, 4, 8), timeout_s=300.0,
                               device="cpu", **kw)


def test_server_round_trip_coalesces_and_matches(teng):  # noqa: F811
    """ScenarioServer / ScenarioClient over local://: concurrent requests
    coalesce into fewer dispatches than requests, every reply is the
    engine's batch-of-1 answer, duplicates and malformed requests get
    typed rejections, and a draining server refuses new work."""
    cfg = _serve_cfg("local://torch-e2e")
    reg = TRegistry()
    scens = [{"demand_scale": 1.0 + 0.1 * i, "horizon_s": 120}
             for i in range(6)]

    async def main():
        server = tserver.ScenarioServer(cfg, registry=reg)
        await server.start()
        try:
            async with tserver.ScenarioClient(cfg.url) as c:
                replies = await asyncio.gather(*[
                    c.request(scens[i], rid=f"c{i}", timeout=300)
                    for i in range(6)])
                dup = await c.request(scens[0], rid="c0", timeout=30)
                bad = await c.request({"volcano": 1.0}, timeout=30)
                server.begin_drain()
                late = await c.request(scens[0], timeout=30)
        finally:
            await server.stop()
        return replies, dup, bad, late

    replies, dup, bad, late = _run(main())
    assert all(r["ok"] for r in replies), replies
    assert max(r["t"]["batch"] for r in replies) > 1
    counters = reg.snapshot()["counters"]
    assert counters["serve.batches_total"] < 6
    assert counters["serve.replies_total"] == 6.0
    assert (dup["error"]["code"], bad["error"]["code"],
            late["error"]["code"]) == ("duplicate", "invalid", "draining")
    refs = [teng.run([req(tschema, f"c{i}", scen_of(tschema, scens[i]))])[0]
            for i in range(6)]
    assert [r["result"] for r in replies] == refs


def test_continuous_server_replies_equal_singletons(teng):  # noqa: F811
    """Continuous batching with mixed horizons and modes: every reply is
    byte-equal (as JSON) to a batch-of-1 run, in fewer dispatches than
    row-blocks."""
    cfg = _serve_cfg("local://torch-e2e-continuous", batching="continuous",
                     starve_limit=3)
    reg = TRegistry()
    scens = [{"demand_scale": 1.0 + 0.1 * i,
              "horizon_s": 120 if i % 2 else 60} for i in range(6)]
    modes = ["reduce", "fleet", "quantiles"] * 2

    async def main():
        server = tserver.ScenarioServer(cfg, registry=reg)
        await server.start()
        assert server.batcher._session.bucket == 8
        try:
            async with tserver.ScenarioClient(cfg.url) as client:
                return await asyncio.gather(*[
                    client.request(scens[i], mode=modes[i], rid=f"c{i}",
                                   timeout=300) for i in range(6)])
        finally:
            await server.stop()

    replies = _run(main())
    assert all(r["ok"] for r in replies), replies
    assert reg.snapshot()["counters"]["serve.batches_total"] < 9
    refs = [teng.run([req(tschema, f"c{i}", scen_of(tschema, scens[i]),
                          modes[i])])[0] for i in range(6)]
    assert [json.dumps(r["result"], sort_keys=True) for r in replies] == \
        [json.dumps(r, sort_keys=True) for r in refs]


def test_bf16_server_round_trip():
    """One request over local:// to a bf16 server with the strict
    telemetry gate set: the reply is the bf16 engine's."""
    cfg = tserver.ServeConfig(
        sim=tcfg(compute_dtype="bf16", telemetry_strict=True),
        url="local://torch-bf16", window_s=0.05, batch_sizes=(1,),
        timeout_s=300.0, device="cpu")
    doc = {"demand_scale": 1.2, "horizon_s": 120}

    async def main():
        server = tserver.ScenarioServer(cfg, registry=TRegistry())
        await server.start()
        try:
            async with tserver.ScenarioClient(cfg.url) as c:
                return await c.request(doc, rid="h0", timeout=300)
        finally:
            await server.stop()

    reply = _run(main())
    assert reply["ok"], reply
    eng = tserver.ScenarioEngine(cfg.sim, (1,), device="cpu")
    assert eng.sim.plan.telemetry == "light"
    want = eng.run([req(tschema, "h0", scen_of(tschema, doc))])[0]
    assert reply["result"] == want
