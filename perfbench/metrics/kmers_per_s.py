"""k-mers counted per second: the k-mers of every job that finished, over
the seconds from the first job's start to the last job's end."""


def read(record):
    done = sum(j["ok"] for j in record["jobs"])
    return done * record["work_per_job"] / record["window_s"]
