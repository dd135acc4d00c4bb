"""Whole plans as upstream's example runs them, with the traffic's
parameters: a plan from the request's seeds (``problem.plan``: a new
planner, and with ``new_scene`` a new scene), then ``optimize`` in calls of
``iters_per_call`` iterations up to ``iters_per_plan``, and the result on
the host (``problem.result``)."""


class Loop:
    def __init__(self, session):
        self.s = session
        tr = session.traffic
        self.iters, self.chunk = tr["iters_per_plan"], tr["iters_per_call"]
        self.new_scene = tr["new_scene"]

    def setup(self):
        s = self.s
        self.scene_seed = s.draw_seed()
        for _ in range(s.traffic.get("warm_requests", 1)):
            self.request(record=False)

    def request(self, record=True):
        s = self.s
        scene_seed = s.draw_seed() if self.new_scene else self.scene_seed
        planner_seed = s.draw_seed()
        with s.span("build"):
            plan = s.problem.plan(scene_seed, planner_seed)
        self.plan = plan
        calls = []
        done = 0
        while done < self.iters:
            n = min(self.chunk, self.iters - done)
            mu_in, state = s.problem.means(plan), s.problem.rng_state(plan)
            with s.span("optimize"):
                out = s.problem.optimize(plan, n)
            calls.append(dict(plan=plan, mu_in=mu_in, rng_state=state, iters=n, out=out))
            done += n
        with s.span("result"):
            result = s.problem.result(plan)
        if record:
            for i, call in enumerate(calls):
                s.offer(**call, result=result if i == len(calls) - 1 else None)
        s.check_finite(result)
        return self.iters * s.problem.num_particles
