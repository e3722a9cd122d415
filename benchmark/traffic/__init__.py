"""Traffic: each mix is a data file `<mix>.json` whose `kind` names the
general generator `<kind>.py` that reads it."""
