"""The application shell: scene setup and the frame loop."""
