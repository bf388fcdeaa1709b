"""sharding/ — logical-axis sharding rules, the train state's and the
caches' axes, and the activation constraints the models call (twin of
`repro/sharding`)."""

from repro_torch.sharding.rules import (  # noqa: F401
    ShardingRules,
    RULES_SINGLE_POD,
    RULES_MULTI_POD,
    rules_for_mesh,
    logical_to_spec,
    param_shardings,
    shard_activation,
    gather_weight,
    set_active,
    get_active,
    no_sharding,
)
