"""Host seconds the warm unit (in set-up) spends warming up program families
before their first capture: the ``warm_s`` of the capture records
(``utils/programs.py captures``) that no window unit made.  A family warms
up once a process, so only the warm unit's records hold a warm-up."""


def read(data):
    from autourdf_tpu_torch.utils import programs

    window = {id(c) for u in data.get("units") or [] for c in u["captures"]}
    warm = [c["warm_s"] for c in programs.captures if id(c) not in window and "warm_s" in c]
    return sum(warm) if warm else None
