from repro_torch.parallel.sharding import (  # noqa: F401
    AxisRules,
    DEFAULT_RULES,
    set_rules,
    get_rules,
    shd,
    logical_spec,
    param_pspecs,
    batch_axes,
    named_shardings,
    force_mesh_axes,
    use_rules,
)
