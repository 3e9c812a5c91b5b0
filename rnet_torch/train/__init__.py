"""Training of the port: schedules and the train/eval steps."""
