"""Host-side utilities of the port: the evaluation metrics, the yml
configuration, frame folders and ffmpeg (`video`) and optical-flow files
(`flow_io`)."""
