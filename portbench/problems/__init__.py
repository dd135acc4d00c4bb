"""One module per problem a configuration names (its ``"problem"`` key):
the inputs made from the seed, the program's planner built on them, and the
comparison of what the planner produced with ``portbench/reference``."""
