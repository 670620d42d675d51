"""How a cell's window calls ``cooper_mapper_torch.ops.odometry.batch_odometry_solve``:
B sweep pairs of the pool per call, each with its own reference clouds and
prior, at the configuration's ``OdometryConfig``."""

from __future__ import annotations

from ..harness import roofline
from ..inputs import pool as pool_lib
from ..reference import solve as reference

QUERY, REFERENCE = ("sharp", "flat"), ("less_sharp", "less_flat")


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.solver = config["odometry"]
        self.prior = traffic["prior"]
        self.n_batch = traffic["batch"]
        self.pool = pool_lib.make_pool(config, traffic, seed, device)

    def feed(self, gen):
        """One call's problems: (what identifies them, the call's arguments)."""
        idx, x0 = pool_lib.draw_problems(self.pool, self.n_batch, self.prior, gen)
        return {"idx": idx, "x0": x0}, self.arguments(idx, x0)

    def arguments(self, idx, x0):
        clouds = {k: pool_lib.gather(self.pool[k], idx) for k in QUERY + REFERENCE}
        return clouds, x0

    def solve(self, args) -> dict:
        from cooper_mapper_torch.config import OdometryConfig
        from cooper_mapper_torch.ops.odometry import batch_odometry_solve
        from cooper_mapper_torch.utils.cloud import Cloud

        clouds, x0 = args
        c = {k: Cloud(v["xyz"], v["mask"], v["ring"], v["rel_time"]) for k, v in clouds.items()}
        x, st = batch_odometry_solve(c["sharp"], c["flat"], c["less_sharp"], c["less_flat"],
                                     x0, OdometryConfig(**self.solver))
        return {"x": x, "converged": st.converged}

    @staticmethod
    def failed(out):
        """Solves that end unconverged after the iteration budget."""
        return ~out["converged"]

    def bound_s(self, args) -> dict:
        clouds, _ = args
        n_refresh = -(-self.solver["max_iterations"] // self.solver["refresh_every"])
        return {"races": roofline.odometry_race_bound_s(
            clouds["sharp"]["mask"], clouds["flat"]["mask"], clouds["less_sharp"]["mask"],
            clouds["less_flat"]["mask"], n_refresh)}

    def reference(self, problems: dict, tf32: bool = False) -> dict:
        """The plain reference's answers to ``problems`` (as ``feed`` gave
        them); with ``tf32`` the control's."""
        clouds, x0 = self.arguments(problems["idx"], problems["x0"])
        x, converged = reference.odometry(clouds["sharp"], clouds["flat"], clouds["less_sharp"],
                                          clouds["less_flat"], x0, self.solver, tf32)
        return {"x": x, "converged": converged}
