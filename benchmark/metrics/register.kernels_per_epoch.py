"""Graph nodes an epoch of the training chunk program (``train_epochs``): its
capture's nodes over the epochs a call runs, the mean over the window
units' captures (``utils/programs.py`` records)."""


def read(data):
    per = [c["nodes"] / c["epochs"] for u in data.get("units") or [] for c in u["captures"]
           if c["name"] == "train_epochs" and c.get("epochs")]
    return sum(per) / len(per) if per else None
