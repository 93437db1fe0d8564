"""The kernel wrappers (lift, rays, corner table, row-gather probes), the
host NMS and rasterizers, target assignment and the build of csrc/. Each
model kernel's wrapper adds one to a counter of its module where it
launches its kernel (`LAUNCHES`, `BWD_LAUNCHES`, ...): `launch_counts()`
reads them all."""


def launch_counts() -> dict:
    """The launch counts of the model kernels' wrappers, the lift's two in
    each of its modes (and the depth-less forward's slot map), the ray
    forward's without a stop and in its stop mode."""
    from . import lift, rays, tables
    return dict(lift=lift.LAUNCHES, corner_table=tables.LAUNCHES,
                rays=rays.LAUNCHES, rays_stop=rays.STOP_LAUNCHES,
                lift_bwd=lift.BWD_LAUNCHES,
                corner_table_bwd=tables.BWD_LAUNCHES,
                rays_bwd=rays.BWD_LAUNCHES,
                lift_bilinear=lift.BILINEAR_LAUNCHES,
                lift_bilinear_bwd=lift.BILINEAR_BWD_LAUNCHES,
                slot_map=lift.SLOT_MAP_LAUNCHES)


def reset_launch_counts() -> None:
    from . import lift, rays, tables
    lift.LAUNCHES = tables.LAUNCHES = rays.LAUNCHES = 0
    rays.STOP_LAUNCHES = 0
    lift.BWD_LAUNCHES = tables.BWD_LAUNCHES = rays.BWD_LAUNCHES = 0
    lift.BILINEAR_LAUNCHES = lift.BILINEAR_BWD_LAUNCHES = 0
    lift.SLOT_MAP_LAUNCHES = 0
