"""Refinement requests on one planner: each request continues from the
current means with ``optimize(iters_per_request)`` and takes the best
trajectory to the host (``get_traj()``), as a client that replans in a
closed loop does. The scene and the planner are built in set-up from the
seed."""


class Loop:
    def __init__(self, session):
        self.s = session
        self.iters = session.traffic["iters_per_request"]

    def setup(self):
        s = self.s
        self.plan = s.problem.plan(s.draw_seed(), s.draw_seed())
        for _ in range(s.traffic.get("warm_requests", 2)):
            self.request(record=False)

    def request(self, record=True):
        s, plan = self.s, self.plan
        mu_in, state = s.problem.means(plan), s.problem.rng_state(plan)
        with s.span("optimize"):
            out = s.problem.optimize(plan, self.iters)
        with s.span("result"):
            result = s.problem.result(plan)
        if record:
            s.offer(plan=plan, mu_in=mu_in, rng_state=state, iters=self.iters, out=out,
                    result=result)
        s.check_finite(result)
        return self.iters * s.problem.num_particles
