"""build_s: host clock around ``JAGIndex.build``, synchronized at both
ends."""


def read(run):
    return run.build_s
