"""The single-device learner that dispatches the learner chunk kernel."""
