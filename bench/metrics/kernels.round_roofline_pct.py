"""The least time one round's work needs on the device
(`bench/roofline.py`, from the real networks' sizes), as a share of the
measured round: the `solve_fleet.execute` spans over the rounds run."""
import roofline


def read(reading):
    reps = reading["record"].get("replans", [])
    rounds = sum(r["rounds"] for r in reps)
    execute = sum(s.dur for s in reading["spans"] if s.name == "solve_fleet.execute")
    if not rounds or execute <= 0:
        return None
    t_phi = reading["cell"].config["solver"]["t_phi"]
    bound_s = roofline.round_work(reading["state"]["nets"], t_phi)["seconds"]
    return 100.0 * bound_s / (execute / rounds)
