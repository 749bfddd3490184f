"""How a cell drives one entry of the port: ``entries/<name>.py`` holds an
``Entry`` class that a traffic file names (``"entry": {"name": ...}``)."""
