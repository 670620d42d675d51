"""How a cell's window calls ``cooper_mapper_torch.ops.scan_match.batch_scan_match``:
B frames of the pool per call, each against its own map and from its own
prior, at the configuration's ``ScanMatchConfig``."""

from __future__ import annotations

from ..harness import roofline
from ..inputs import pool as pool_lib
from ..reference import solve as reference

CLOUDS = ("corner", "surf", "ref_corner", "ref_surf")


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.solver = config["scan_match"]
        self.prior = traffic["prior"]
        self.n_batch = traffic["batch"]
        self.pool = pool_lib.make_pool(config, traffic, seed, device)

    def feed(self, gen):
        idx, x0 = pool_lib.draw_problems(self.pool, self.n_batch, self.prior, gen)
        return {"idx": idx, "x0": x0}, self.arguments(idx, x0)

    def arguments(self, idx, x0):
        return {k: pool_lib.gather(self.pool[k], idx) for k in CLOUDS}, x0

    def solve(self, args) -> dict:
        from cooper_mapper_torch.config import ScanMatchConfig
        from cooper_mapper_torch.ops.scan_match import batch_scan_match
        from cooper_mapper_torch.utils.cloud import Cloud

        clouds, x0 = args
        c = {k: Cloud(v["xyz"], v["mask"], v["ring"], v["rel_time"]) for k, v in clouds.items()}
        res = batch_scan_match(c["corner"], c["surf"], c["ref_corner"], c["ref_surf"], x0,
                               ScanMatchConfig(**self.solver))
        return {"x": res.x, "converged": res.converged, "success": res.success}

    @staticmethod
    def failed(out):
        """Solves that do not pass the score gate, or end unconverged."""
        return ~out["success"]

    def bound_s(self, args) -> dict:
        clouds, _ = args
        return {"knn": roofline.knn_bound_s(
            clouds["corner"]["mask"], clouds["surf"]["mask"], clouds["ref_corner"]["mask"],
            clouds["ref_surf"]["mask"], self.solver["knn"], self.solver["max_iterations"] + 1)}

    def reference(self, problems: dict, tf32: bool = False) -> dict:
        clouds, x0 = self.arguments(problems["idx"], problems["x0"])
        x, converged, success = reference.scan_match(
            clouds["corner"], clouds["surf"], clouds["ref_corner"], clouds["ref_surf"], x0,
            self.solver, tf32)
        return {"x": x, "converged": converged, "success": success}
