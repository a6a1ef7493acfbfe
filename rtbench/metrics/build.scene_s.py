"""``build.scene_s``: seconds of ``Scene.build`` (pack, BVH, upload), a
host clock around the call and a synchronise (rtbench/harness.py)."""


def read(run, state, trace, spans):
    return spans.get("build.scene_s")
