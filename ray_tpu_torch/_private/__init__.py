"""In-process services of the port: its copies of the flight recorder, the
deadline context, the device data plane and the serializer it rides on."""
