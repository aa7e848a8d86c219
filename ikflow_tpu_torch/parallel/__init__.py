"""Streaming exact IK over large pose sets (``fleet.solve_exact_megabatch``)."""
