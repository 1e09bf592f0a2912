"""API-gateway flow control (reference
``sentinel-adapter/sentinel-api-gateway-adapter-common``): route/custom-API
granularity rules with request-attribute matchers, converted onto the
hot-param engine.

The PyTorch port's copy of ``sentinel_tpu/gateway/__init__.py``."""

from sentinel_tpu_torch.gateway.api import (
    URL_MATCH_STRATEGY_EXACT,
    URL_MATCH_STRATEGY_PREFIX,
    URL_MATCH_STRATEGY_REGEX,
    ApiDefinition,
    ApiPathPredicateItem,
    GatewayApiDefinitionManager,
)
from sentinel_tpu_torch.gateway.param import (
    DictRequestItemParser,
    GatewayParamParser,
    RequestItemParser,
)
from sentinel_tpu_torch.gateway.rules import (
    GATEWAY_DEFAULT_PARAM,
    GATEWAY_NOT_MATCH_PARAM,
    PARAM_MATCH_STRATEGY_CONTAINS,
    PARAM_MATCH_STRATEGY_EXACT,
    PARAM_MATCH_STRATEGY_PREFIX,
    PARAM_MATCH_STRATEGY_REGEX,
    PARAM_PARSE_STRATEGY_CLIENT_IP,
    PARAM_PARSE_STRATEGY_COOKIE,
    PARAM_PARSE_STRATEGY_HEADER,
    PARAM_PARSE_STRATEGY_HOST,
    PARAM_PARSE_STRATEGY_URL_PARAM,
    RESOURCE_MODE_CUSTOM_API_NAME,
    RESOURCE_MODE_ROUTE_ID,
    GatewayFlowRule,
    GatewayParamFlowItem,
    GatewayRuleManager,
)

__all__ = [
    "GatewayFlowRule", "GatewayParamFlowItem", "GatewayRuleManager",
    "ApiDefinition", "ApiPathPredicateItem", "GatewayApiDefinitionManager",
    "GatewayParamParser", "RequestItemParser", "DictRequestItemParser",
    "RESOURCE_MODE_ROUTE_ID", "RESOURCE_MODE_CUSTOM_API_NAME",
    "PARAM_PARSE_STRATEGY_CLIENT_IP", "PARAM_PARSE_STRATEGY_HOST",
    "PARAM_PARSE_STRATEGY_HEADER", "PARAM_PARSE_STRATEGY_URL_PARAM",
    "PARAM_PARSE_STRATEGY_COOKIE",
    "PARAM_MATCH_STRATEGY_EXACT", "PARAM_MATCH_STRATEGY_PREFIX",
    "PARAM_MATCH_STRATEGY_REGEX", "PARAM_MATCH_STRATEGY_CONTAINS",
    "URL_MATCH_STRATEGY_EXACT", "URL_MATCH_STRATEGY_PREFIX",
    "URL_MATCH_STRATEGY_REGEX",
    "GATEWAY_NOT_MATCH_PARAM", "GATEWAY_DEFAULT_PARAM",
]
