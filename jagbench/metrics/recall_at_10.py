"""recall_at_10: mean recall@10 of every query served in the window
against the reference's exact filtered top-10 (``reference.Judge``)."""


def read(run):
    return run.recall
