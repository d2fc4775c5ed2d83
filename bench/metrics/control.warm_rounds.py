"""Mean engine rounds of the accepted solve over the window's event
epochs (`EpochReport.rounds`): how many rounds a warm start still needs."""


def read(reading):
    rounds = [r["report"].rounds for r in reading["record"].get("epochs", [])
              if "report" in r and r["report"].events]
    return sum(rounds) / len(rounds) if rounds else None
