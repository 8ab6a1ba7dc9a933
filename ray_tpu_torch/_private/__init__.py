"""In-process services of the port: its copy of the flight recorder."""
