"""Training: AdamW with its schedules and clipping, and the train step."""
