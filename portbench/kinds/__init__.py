"""The traffic generators, one per kind of mix (``portbench/traffic/<mix>.json``
names its ``kind``): each a ``Traffic`` that makes its inputs from the seed,
warms up, runs one unit of the window at a time and checks the outputs."""
