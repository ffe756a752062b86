"""Config, image I/O, the schedule memo store and timing on the card."""
