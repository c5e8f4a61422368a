// Tenancy preflight: the CDI createContainer / poststop hook of an MPS
// request (the JAX package's tpulib/native/tenancy_preflight.cc).
//
// A container runtime runs CDI hooks on the host, which may have no
// Python, so the hook is a binary of its own. The kubelet plugin builds
// it from this file at first use (kubeletplugin/native_hook.py) and
// copies it into <state root>/bin/, where the claim's CDI spec points.
//
// createContainer: REGISTER <id> <hbm> with the request's tenancy agent
// (kubeletplugin/tenancy_agent.py); a DENIED answer (over maxClients, or
// over the GPU's memory) exits 1 and the runtime does not start the
// container. An agent that cannot be reached exits 1 too: admission
// fails closed. poststop (--release): RELEASE <id>, so that a container
// started again (a new OCI id) does not keep its old slot; when the agent
// cannot be reached it leaves a tombstone in released.d/, which the agent
// applies before its next admission, and exits 0. The id is the OCI
// state's, read from stdin; an id that holds a path is refused.
//
// Exit codes and answers are those of kubeletplugin/tenancy_preflight.py.

#include <fcntl.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/time.h>
#include <sys/un.h>
#include <unistd.h>

#include <cstdio>
#include <cstring>
#include <string>

namespace {

// The value of the first "id" key of the OCI state JSON on stdin.
std::string StateId() {
  std::string input;
  char buf[4096];
  ssize_t n;
  while ((n = read(STDIN_FILENO, buf, sizeof(buf))) > 0) {
    input.append(buf, static_cast<size_t>(n));
    if (input.size() > (1u << 20)) break;  // a state is a few KiB
  }
  size_t key = input.find("\"id\"");
  if (key == std::string::npos) return "";
  size_t colon = input.find(':', key);
  if (colon == std::string::npos) return "";
  size_t open = input.find('"', colon);
  if (open == std::string::npos) return "";
  size_t close = input.find('"', open + 1);
  if (close == std::string::npos) return "";
  return input.substr(open + 1, close - open - 1);
}

// One request to the agent's socket; 0 and its answer (without the
// newline), or -1 when the agent cannot be reached.
int Query(const std::string& sock_path, const std::string& request,
          std::string* reply) {
  sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  // sun_path holds 108 bytes with its terminating NUL.
  if (sock_path.size() >= sizeof(addr.sun_path)) return -1;
  std::memcpy(addr.sun_path, sock_path.c_str(), sock_path.size());
  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  // A wedged agent must not hang the container's start: every socket
  // call is bounded (connect honours SO_SNDTIMEO on Linux), below the
  // spec's own hook timeout.
  timeval tv{5, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    close(fd);
    return -1;
  }
  std::string line = request + "\n";
  if (write(fd, line.c_str(), line.size()) !=
      static_cast<ssize_t>(line.size())) {
    close(fd);
    return -1;
  }
  char buf[4096];
  ssize_t n;
  while ((n = read(fd, buf, sizeof(buf))) > 0) {
    reply->append(buf, static_cast<size_t>(n));
    if (reply->back() == '\n') break;
  }
  close(fd);
  if (n < 0) return -1;  // the read timed out or failed
  while (!reply->empty() &&
         (reply->back() == '\n' || reply->back() == '\r')) {
    reply->pop_back();
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string dir, hbm = "0", client;
  bool release = false;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--dir" && i + 1 < argc) {
      dir = argv[++i];
    } else if (a == "--hbm-bytes" && i + 1 < argc) {
      hbm = argv[++i];
    } else if (a == "--client-id" && i + 1 < argc) {
      client = argv[++i];
    } else if (a == "--release") {
      release = true;
    }
  }
  if (dir.empty()) {
    std::fprintf(stderr, "tenancy-preflight: --dir required\n");
    return 1;
  }
  if (client.empty()) client = StateId();
  if (client.empty() || client.find('/') != std::string::npos ||
      client == "." || client == "..") {
    std::fprintf(stderr, "tenancy-preflight: no usable client identity\n");
    return release ? 0 : 1;  // a poststop never fails the teardown
  }
  std::string request =
      release ? "RELEASE " + client : "REGISTER " + client + " " + hbm;
  std::string reply;
  if (Query(dir + "/agent.sock", request, &reply) != 0) {
    std::fprintf(stderr, "tenancy-preflight: agent unreachable at %s\n",
                 dir.c_str());
    if (!release) return 1;  // fail closed
    // mkdir is not recursive: a removed agent directory is not made
    // again, and then no tombstone is left.
    std::string rd = dir + "/released.d";
    mkdir(rd.c_str(), 0755);
    int tfd = open((rd + "/" + client).c_str(), O_WRONLY | O_CREAT | O_TRUNC,
                   0644);
    if (tfd >= 0) close(tfd);
    return 0;
  }
  if (release || reply.rfind("OK", 0) == 0) return 0;
  std::fprintf(stderr, "tenancy-preflight: %s\n", reply.c_str());
  return 1;
}
