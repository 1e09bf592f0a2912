"""Port parity: the API gateway (``sentinel_tpu_torch.gateway`` and
``adapters.asgi_gateway``) against ``sentinel_tpu``'s.

Twins of the 12 tests of ``tests/test_gateway.py``: each scenario runs on
both packages (twin ManualClocks; the port's runtime on the CPU) with
rule objects built separately for each side (``GatewayRuleManager.
load_rules`` writes the param item's index into the caller's objects).
Parsed args, verdicts, command bodies and engine state must agree
exactly; there is no tolerance. Each scenario also keeps the reference
test's own expectations.
"""

import asyncio
import json
import types

import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu.adapters as jad
import sentinel_tpu.gateway as jgw
import sentinel_tpu.gateway.codec as jcodec
import sentinel_tpu.transport as jtr
import sentinel_tpu_torch as stt
import sentinel_tpu_torch.adapters as tad
import sentinel_tpu_torch.gateway as tgw
import sentinel_tpu_torch.gateway.codec as tcodec
import sentinel_tpu_torch.transport as ttr
from sentinel_tpu_torch import convert

torch.set_num_threads(2)

T0 = 1_785_000_000_000
SIDES = {
    "jax": types.SimpleNamespace(pkg=stpu, gw=jgw, ad=jad, tr=jtr,
                                 codec=jcodec),
    "torch": types.SimpleNamespace(pkg=stt, gw=tgw, ad=tad, tr=ttr,
                                   codec=tcodec),
}


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def _sentinel(name, side, clk, **cfg):
    kw = dict(max_resources=64, max_param_rules=16, param_table_slots=256)
    kw.update(cfg)
    extra = {"device": "cpu"} if name == "torch" else {}
    return side.pkg.Sentinel(side.pkg.load_config(**kw), clock=clk,
                             **extra)


def twin(scenario, **cfg):
    """``scenario(x)`` on both packages; ``x`` carries ``pkg``, ``gw``,
    ``ad``, ``tr``, ``codec``, ``sph``, ``mgr`` (a GatewayRuleManager)
    and ``clk`` → the port's observations, equal to the reference's."""
    got, engines = {}, {}
    for name, side in SIDES.items():
        clk = side.pkg.ManualClock(start_ms=T0)
        sph = _sentinel(name, side, clk, **cfg)
        x = types.SimpleNamespace(**vars(side), sph=sph, clk=clk,
                                  mgr=side.gw.GatewayRuleManager(sph))
        got[name] = scenario(x)
        engines[name] = sph
    assert got["torch"] == got["jax"]
    assert convert.leaf_diff(convert.to_numpy(engines["jax"]._state),
                             convert.to_numpy(engines["torch"]._state)) == []
    for sph in engines.values():
        sph.close()
    return got["torch"]


def gw_burst(x, resource, n, args):
    p = b = 0
    for _ in range(n):
        try:
            with x.sph.entry(resource, args=args):
                p += 1
        except x.pkg.ParamFlowException:
            b += 1
    return p, b


def _ip_item(x):
    return x.gw.GatewayParamFlowItem(
        parse_strategy=x.gw.PARAM_PARSE_STRATEGY_CLIENT_IP)


# --------------------------------------------------------------- conversion

def test_route_rule_without_param_item_caps_route_qps():
    def sc(x):
        x.mgr.load_rules([x.gw.GatewayFlowRule(resource="route-a", count=5)])
        args = x.gw.GatewayParamParser(x.mgr).parse_parameters(
            "route-a", {"path": "/x"})
        return [args, gw_burst(x, "route-a", 8, args)]
    assert twin(sc) == [["$D"], (5, 3)]


def test_client_ip_rule_throttles_per_ip():
    def sc(x):
        x.mgr.load_rules([x.gw.GatewayFlowRule(resource="route-a", count=2,
                                               param_item=_ip_item(x))])
        parser = x.gw.GatewayParamParser(x.mgr)
        a1 = parser.parse_parameters("route-a", {"remote": "10.0.0.1"})
        a2 = parser.parse_parameters("route-a", {"remote": "10.0.0.2"})
        return [gw_burst(x, "route-a", 3, a1), gw_burst(x, "route-a", 3, a2)]
    assert twin(sc) == [(2, 1), (2, 1)]


def test_header_pattern_exact_only_matching_values_throttled():
    def sc(x):
        x.mgr.load_rules([x.gw.GatewayFlowRule(
            resource="route-a", count=1,
            param_item=x.gw.GatewayParamFlowItem(
                parse_strategy=x.gw.PARAM_PARSE_STRATEGY_HEADER,
                field_name="X-User", pattern="mallory",
                match_strategy=x.gw.PARAM_MATCH_STRATEGY_EXACT))])
        parser = x.gw.GatewayParamParser(x.mgr)
        bad = parser.parse_parameters("route-a",
                                      {"headers": {"X-User": "mallory"}})
        good = parser.parse_parameters("route-a",
                                       {"headers": {"X-User": "alice"}})
        return [bad, good, gw_burst(x, "route-a", 3, bad),
                gw_burst(x, "route-a", 10, good)]
    assert twin(sc) == [["mallory"], ["$NM"], (1, 2), (10, 0)]


def test_url_param_regex_and_contains():
    def sc(x):
        g = x.gw
        x.mgr.load_rules([
            g.GatewayFlowRule(resource="r1", count=1,
                              param_item=g.GatewayParamFlowItem(
                                  parse_strategy=g.PARAM_PARSE_STRATEGY_URL_PARAM,
                                  field_name="uid", pattern=r"\d+",
                                  match_strategy=g.PARAM_MATCH_STRATEGY_REGEX)),
            g.GatewayFlowRule(resource="r2", count=1,
                              param_item=g.GatewayParamFlowItem(
                                  parse_strategy=g.PARAM_PARSE_STRATEGY_HEADER,
                                  field_name="UA", pattern="bot",
                                  match_strategy=g.PARAM_MATCH_STRATEGY_CONTAINS)),
        ])
        p = g.GatewayParamParser(x.mgr)
        return [p.parse_parameters("r1", {"params": {"uid": "42"}}),
                p.parse_parameters("r1", {"params": {"uid": "abc"}}),
                p.parse_parameters("r2", {"headers": {"UA": "somebot/1"}}),
                p.parse_parameters("r2", {"headers": {"UA": "firefox"}})]
    assert twin(sc) == [["42"], ["$NM"], ["somebot/1"], ["$NM"]]


def test_mixed_param_and_non_param_rules_share_args_array():
    def sc(x):
        x.mgr.load_rules([
            x.gw.GatewayFlowRule(resource="route-a", count=2,
                                 param_item=_ip_item(x)),
            x.gw.GatewayFlowRule(resource="route-a", count=10),
        ])
        parser = x.gw.GatewayParamParser(x.mgr)
        args = parser.parse_parameters("route-a", {"remote": "1.2.3.4"})
        out = [args, x.mgr.args_length("route-a"),
               gw_burst(x, "route-a", 4, args)]
        p = b = 0
        for i in range(12):
            a = parser.parse_parameters("route-a", {"remote": f"9.9.9.{i}"})
            pp, bb = gw_burst(x, "route-a", 1, a)
            p += pp
            b += bb
        return out + [(p, b)]
    assert twin(sc) == [["1.2.3.4", "$D"], 2, (2, 2), (8, 4)]


def test_interval_and_burst_conversion():
    def sc(x):
        x.mgr.load_rules([x.gw.GatewayFlowRule(
            resource="route-a", count=2, interval_sec=2, burst=1,
            param_item=_ip_item(x))])
        args = x.gw.GatewayParamParser(x.mgr).parse_parameters(
            "route-a", {"remote": "1.1.1.1"})
        out = [gw_burst(x, "route-a", 5, args)]
        x.clk.advance_ms(2100)
        out.append(gw_burst(x, "route-a", 3, args))
        x.clk.advance_ms(60_000)
        out.append(gw_burst(x, "route-a", 5, args))
        return out
    assert twin(sc) == [(3, 2), (2, 1), (3, 2)]


def test_invalid_rules_skipped():
    def sc(x):
        g = x.gw
        x.mgr.load_rules([
            g.GatewayFlowRule(resource="", count=1),
            g.GatewayFlowRule(resource="ok", count=-1),
            g.GatewayFlowRule(resource="ok", count=1, interval_sec=0),
            g.GatewayFlowRule(resource="ok", count=1,
                              param_item=g.GatewayParamFlowItem(
                                  parse_strategy=g.PARAM_PARSE_STRATEGY_HEADER,
                                  field_name="")),
        ])
        return [x.mgr.all_rules(), x.sph.get_param_flow_rules()]
    assert twin(sc) == [[], []]


# ------------------------------------------------------------- API groups

def test_api_definition_matching():
    out = {}
    for name, side in SIDES.items():
        g = side.gw
        mgr = g.GatewayApiDefinitionManager()
        seen = []
        mgr.add_listener(lambda defs: seen.append([d.api_name
                                                   for d in defs]))
        mgr.load_api_definitions([
            g.ApiDefinition("products", (
                g.ApiPathPredicateItem("/products"),
                g.ApiPathPredicateItem("/products/**",
                                       g.URL_MATCH_STRATEGY_PREFIX))),
            g.ApiDefinition("orders", (
                g.ApiPathPredicateItem(r"/orders/\d+",
                                       g.URL_MATCH_STRATEGY_REGEX),)),
            g.ApiDefinition("", ()),
            g.ApiDefinition("one", (
                g.ApiPathPredicateItem("/a/*/c?", g.URL_MATCH_STRATEGY_PREFIX),
                g.ApiPathPredicateItem("", g.URL_MATCH_STRATEGY_EXACT))),
        ])
        paths = ("/products", "/products/42/detail", "/orders/17",
                 "/orders/aa", "/other", "/a/b/cd", "/a/b/x/cd", "/a//c",
                 "")
        out[name] = ([mgr.matching_apis(p) for p in paths],
                     mgr.get_api_definition("products").api_name,
                     mgr.get_api_definition("missing"), seen,
                     side.codec.api_definitions_to_json(
                         mgr.get_api_definitions()))
    assert out["torch"] == out["jax"]
    assert out["torch"][0][:5] == [["products"], ["products"], ["orders"],
                                   [], []]


def test_api_group_rule_end_to_end():
    def sc(x):
        api_mgr = x.gw.GatewayApiDefinitionManager()
        api_mgr.load_api_definitions([x.gw.ApiDefinition("my_api", (
            x.gw.ApiPathPredicateItem("/api/**",
                                      x.gw.URL_MATCH_STRATEGY_PREFIX),))])
        x.mgr.load_rules([x.gw.GatewayFlowRule(
            resource="my_api",
            resource_mode=x.gw.RESOURCE_MODE_CUSTOM_API_NAME, count=3)])
        path = "/api/users"
        args = x.gw.GatewayParamParser(x.mgr).parse_parameters(
            "my_api", {"path": path})
        return [api_mgr.matching_apis(path), gw_burst(x, "my_api", 5, args)]
    assert twin(sc) == [["my_api"], (3, 2)]


def test_user_and_gateway_param_rules_coexist():
    def sc(x):
        x.sph.load_param_flow_rules([x.pkg.ParamFlowRule(
            resource="svc", param_idx=0, count=1)])
        x.mgr.load_rules([x.gw.GatewayFlowRule(resource="route-a", count=2,
                                               param_item=_ip_item(x))])
        args = x.gw.GatewayParamParser(x.mgr).parse_parameters(
            "route-a", {"remote": "8.8.8.8"})
        out = [gw_burst(x, "route-a", 3, args), gw_burst(x, "svc", 2, ("k",))]
        x.sph.load_param_flow_rules([x.pkg.ParamFlowRule(
            resource="svc", param_idx=0, count=5)])
        out.append(gw_burst(x, "route-a", 3, args))
        return out
    assert twin(sc) == [(2, 1), (1, 1), (2, 1)]


def test_gateway_command_surface():
    """The four ``gateway/*`` commands: bodies equal byte for byte (the
    dashboard client speaks the reference's JSON), bad payloads 400."""
    rules_json = json.dumps([
        {"resource": "route-a", "resourceMode": 0, "count": 7.0,
         "intervalSec": 1, "paramItem": {"parseStrategy": 0}},
        {"resource": "api-b", "resourceMode": 1, "grade": 1, "count": 3,
         "intervalSec": 2, "controlBehavior": 2, "burst": 1,
         "maxQueueingTimeoutMs": 250,
         "paramItem": {"parseStrategy": 2, "fieldName": "X-T",
                       "pattern": "t.*", "matchStrategy": 2}},
        {"resource": "", "count": 1}])
    defs_json = json.dumps([
        {"apiName": "my-api",
         "predicateItems": [{"pattern": "/foo/**", "matchStrategy": 1},
                            {"pattern": "/x", "matchStrategy": 0}]}])

    def sc(x):
        apis = x.gw.GatewayApiDefinitionManager()
        center = x.tr.CommandCenter()
        x.tr.register_default_handlers(center, x.sph, gateway_manager=x.mgr,
                                       api_definition_manager=apis)
        out = []
        for cmd, params in (
                ("gateway/updateRules", {"data": rules_json}),
                ("gateway/getRules", {}),
                ("gateway/updateApiDefinitions", {"data": defs_json}),
                ("gateway/getApiDefinitions", {}),
                ("gateway/updateRules", {"data": "not json"}),
                ("gateway/updateApiDefinitions", {"data": "[{}]"}),
                ("gateway/getRules", {})):
            resp = center.handle(cmd, x.tr.CommandRequest(parameters=params))
            out.append((cmd, resp.success, resp.code, resp.result))
        out.append([str(r) for r in x.sph.get_param_flow_rules()])
        return out
    got = twin(sc)
    assert json.loads(got[1][3])[0]["count"] == 7.0
    assert json.loads(got[3][3])[0]["predicateItems"][0]["pattern"] \
        == "/foo/**"
    assert got[4][1:3] == (False, 400)


def test_gateway_asgi_middleware_end_to_end():
    """SentinelGatewayFilter analog: route + API-group resources with a
    header matcher and a URL-param route rule, driven through a fake ASGI
    app; statuses, the served paths and the node totals agree."""
    def sc(x):
        g = x.gw
        apis = g.GatewayApiDefinitionManager()
        apis.load_api_definitions([g.ApiDefinition("orders_api", (
            g.ApiPathPredicateItem("/orders/**",
                                   g.URL_MATCH_STRATEGY_PREFIX),))])
        x.mgr.load_rules([
            g.GatewayFlowRule(resource="orders_api", resource_mode=1,
                              count=2, param_item=g.GatewayParamFlowItem(
                                  parse_strategy=g.PARAM_PARSE_STRATEGY_HEADER,
                                  field_name="X-Tenant")),
            g.GatewayFlowRule(resource="/search", count=1,
                              param_item=g.GatewayParamFlowItem(
                                  parse_strategy=g.PARAM_PARSE_STRATEGY_URL_PARAM,
                                  field_name="q")),
            g.GatewayFlowRule(resource="/search", count=1,
                              param_item=g.GatewayParamFlowItem(
                                  parse_strategy=g.PARAM_PARSE_STRATEGY_COOKIE,
                                  field_name="sid", pattern="vip",
                                  match_strategy=g.PARAM_MATCH_STRATEGY_PREFIX)),
        ])
        served = []

        async def app(scope, receive, send):
            served.append(scope["path"])
            await send({"type": "http.response.start", "status": 200,
                        "headers": []})
            await send({"type": "http.response.body", "body": b"ok"})

        guarded = x.ad.SentinelGatewayASGIMiddleware(app, x.sph, x.mgr, apis)

        def request(path, tenant, qs=b"", cookie=b""):
            sent = []

            async def drive():
                async def receive():
                    return {"type": "http.request", "body": b"",
                            "more_body": False}

                async def send(msg):
                    sent.append(msg)
                headers = [(b"x-tenant", tenant.encode())]
                if cookie:
                    headers.append((b"cookie", cookie))
                await guarded({"type": "http", "path": path,
                               "method": "GET", "query_string": qs,
                               "client": ("10.1.1.1", 5000),
                               "headers": headers}, receive, send)
            asyncio.run(drive())
            return sent[0]["status"]

        codes_a = [request("/orders/1", "tenant-a") for _ in range(4)]
        codes_b = [request("/orders/2", "tenant-b") for _ in range(2)]
        search = [request("/search", "t", qs=b"q=a&q=b", cookie=c)
                  for c in (b"sid=vip1", b"sid=vip2; x=1", b"sid=no",
                            b"sid=no")]
        return [codes_a, codes_b, search, list(served),
                request("/health", "tenant-a"),
                {n: x.sph.node_totals(n)["pass"]
                 for n in ("orders_api", "/orders/1", "/search")}]
    got = twin(sc)
    assert got[0] == [200, 200, 429, 429]
    assert got[1] == [200, 200]
    assert got[4] == 200
