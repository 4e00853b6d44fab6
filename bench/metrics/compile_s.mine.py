"""Rule compile: the mean seconds of compile_rulebook + place_rulebook a job (the benchmark's clock, synchronised)."""

UNIT = "s"


def read(run):
    jobs = run.get("jobs") or []
    return sum(j["compile_s"] for j in jobs) / len(jobs) if jobs else None
