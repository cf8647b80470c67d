"""AdamW, global-norm clipping and learning-rate schedules."""
