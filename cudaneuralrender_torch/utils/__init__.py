"""Config, image I/O and the schedule memo store."""
