"""In-process services of the port: its copies of the flight recorder and
of the deadline context."""
